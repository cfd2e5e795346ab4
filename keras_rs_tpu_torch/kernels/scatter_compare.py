"""Times the row-scatter kernel (B2, B3, B4) of two checkouts on one card.

    python3 keras_rs_tpu_torch/kernels/scatter_compare.py PARENT_TREE NEW_TREE

Trees as in flash_compare.py, timed the same way: parent, new, new,
parent, each in a process of its own that builds that tree's
csrc/row_ops.cu; CUDA-event means over 20 launches after a warm-up, in
milliseconds. Inputs from seed 0, as chip_smoke.py lays them out: tables
of 6,000,000 rows, N = 2,818,048 positions (the MLPerf DLRM batch's
unique capacity), the live prefix sorted distinct random rows, the tail
the sink (the last row) carrying the sink's own bytes:
  B3 `scatter_rows`         bf16 [128] rows, n_valid 2,730,535 (capacity
                            mode's fixed batch);
  B4 `_scatter_rows_multi`  bf16 [128] + f32 [128] rows, and
  B2 `scatter_row_blocks`   f32 [3, 128] groups, both at n_valid
                            2,442,356 (the 4M-cap batch).
Prints the card's name and power limit, one JSON line per run and a
closing table.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROWS = 6_000_000
N = 2_818_048
CASES = [  # label, wrapper, streams (dtype name, row shape), n_valid
    ("B3", "scatter_rows", [("bfloat16", (128,))], 2_730_535),
    ("B4", "_scatter_rows_multi",
     [("bfloat16", (128,)), ("float32", (128,))], 2_442_356),
    ("B2", "scatter_row_blocks", [("float32", (3, 128))], 2_442_356),
]


def time_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from keras_rs_tpu_torch.kernels.flash_compare import time_ms
    from keras_rs_tpu_torch.ops import row_ops

    dev = torch.device("cuda", 0)
    times = {}
    for label, wrapper, streams, nv in CASES:
        g = torch.Generator(device=dev).manual_seed(0)
        idx = torch.full((N,), ROWS - 1, dtype=torch.int32, device=dev)
        idx[:nv] = torch.randperm(ROWS - 1, generator=g, device=dev)[:nv] \
            .sort().values.to(torch.int32)
        tables, rows = [], []
        for dtype_name, shape in streams:
            dtype = getattr(torch, dtype_name)
            tables.append(torch.randn((ROWS,) + shape, generator=g,
                                      device=dev).to(dtype))
            rows.append(torch.randn((N,) + shape, generator=g,
                                    device=dev).to(dtype))
            rows[-1][nv:] = tables[-1][ROWS - 1]
        n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
        fn = getattr(row_ops, wrapper)
        if len(streams) == 1:
            call = lambda: fn(tables[0], idx, rows[0], n_valid)  # noqa: E731
        else:
            call = lambda: fn(tables, idx, rows, n_valid)  # noqa: E731
        times[label] = time_ms(call)
        del tables, rows, idx
        torch.cuda.empty_cache()
    return times


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(time_tree(sys.argv[2])))
        return 0
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from keras_rs_tpu_torch.kernels import flash_compare

    return flash_compare.compare(__file__, *sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
