"""One run of a small cell (small.py) on the CPU, in a process of its
own, as the multi-rank tests need it (a failing rank ends the process):

  python -m benchmark.tests.small_run <workload> <seed> <seconds> \
      <chips> '<JSON of configuration keys to set>'

With chips > 1 the run goes through run.Ranks, as a cell on several
cards does, over gloo. The result's line comes last on standard output;
the exit code is the run's.
"""

from __future__ import annotations

import json
import sys

import torch

from benchmark import run
from benchmark.tests.small import small_cell


def main(argv: list[str]) -> int:
    workload, seed, seconds, chips, keys = argv
    cell = small_cell(workload)
    cell.config.update(json.loads(keys))
    cell.workload = dict(cell.workload, chips=int(chips))
    if int(chips) > 1:
        ranks = run.Ranks(cell, int(seed), float(seconds), False, "cpu")
        try:
            result, code = ranks.run()
        finally:
            ranks.stop(wait=False)
    else:
        torch.set_num_threads(run.HOST_THREADS)
        result, code = run.run_cell(cell, int(seed), float(seconds), False,
                                    torch.device("cpu"))
    if code:
        return code
    run.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
