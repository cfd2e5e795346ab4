"""The uncut packed cell (dlrm-packed-uncut.multihot, four cards),
rehearsed on the CPU: a copy of its configuration cut to the small
cell's size (small.py: vocabularies of at most 3,000 rows) runs on 4
gloo ranks through run.Ranks (small_run.py), and agrees with the same
cell at D = 1 and with the reference within the multi-rank test's
tolerances; a rank that skips its sparse update (at D = 2) fails the
check. The three runs go at once, each a process of its own. The step's
collectives send at least counts_sharded's floor at D = 2 and 4, and
the two readers of the exchange read a synthetic trace.
"""

import json
import statistics
import subprocess
import sys
import time

import pytest

from benchmark import check, counts_sharded, run, traffic
from benchmark.record import RunRecord
from benchmark.spec import metric_reader
from benchmark.tests.small import small_cell
from benchmark.tests.test_perfbench_multirank import (
    CASE_TIMEOUT_S,
    CHANGE_TOL,
    FIRST_GRAD_TOL,
    LOSS_TOL,
    MEDIAN_CHANGE_TOL,
    ROOT,
)
from benchmark.trace import Trace

SEED = 2**31 + 8209
WORKLOAD = "dlrm-packed-uncut.multihot"
RUNS = {
    # name: (chips, configuration keys)
    "d4": (4, {"port_module": "benchmark.tests.counting"}),
    "d1": (1, {"port_module": "benchmark.tests.counting",
               "wraps": "benchmark.port",
               "steps_after_first": run.AGREE_STEPS}),
    "d2_skip": (2, {"port_module": "benchmark.tests.counting", "cards": 2,
                    "rank_fault": "skip_update"}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run's (exit code, standard error, result, records), the
    three started at once; --seconds 0 runs one window step."""
    procs = {}
    for name, (chips, keys) in RUNS.items():
        path = tmp_path_factory.mktemp(name)
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-m", "benchmark.tests.small_run", WORKLOAD,
             str(SEED), "0", str(chips),
             json.dumps(dict(keys, record_to=str(path)))],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + CASE_TIMEOUT_S
    out = {}
    try:
        for name, (path, p) in procs.items():
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            result = (json.loads(stdout.strip().splitlines()[-1])
                      if p.returncode == 0 else None)
            records = {f.stem: json.loads(f.read_text())
                       for f in path.glob("*.json")}
            out[name] = (p.returncode, stderr, result, records)
    finally:
        for _, p in procs.values():
            p.kill()
    return out


def test_four_ranks_are_correct_and_read_as_one_rank(runs):
    code, err, four, d4 = runs["d4"]
    assert code == 0, err[-4000:]
    code, err, one, d1 = runs["d1"]
    assert code == 0, err[-4000:]
    assert four["correct"], four["check"]
    assert four["window_steps_per_rank"] == [1, 1, 1, 1]
    assert four["device"]["count"] == 4
    assert one["correct"], one["check"]
    for kind in ("first", "late"):
        assert d4[kind]["losses"] == pytest.approx(d1[kind]["losses"],
                                                   rel=LOSS_TOL)
        if kind == "first":
            grad = check._gaps(d4[kind]["grad_norms"],
                               d1[kind]["grad_norms"], d1[kind]["grad_norms"])
            assert max(grad.values()) <= FIRST_GRAD_TOL, grad
        change = check._gaps(d4[kind]["change_norms"],
                             d1[kind]["change_norms"],
                             d1[kind]["change_norms"])
        assert statistics.median(change.values()) <= MEDIAN_CHANGE_TOL
        assert max(change.values()) <= CHANGE_TOL, change


def test_a_rank_that_skips_its_sparse_update_is_not_correct(runs):
    code, err, result, _ = runs["d2_skip"]
    assert code == 0, err[-4000:]
    assert not result["correct"]
    assert result["check"]["table_change_gap"]["value"] > (
        result["check"]["table_change_gap"]["limit"])


@pytest.mark.parametrize("name, D", [("d4", 4), ("d2_skip", 2)])
def test_the_exchange_sends_at_least_the_floor(runs, name, D):
    code, err, _, records = runs[name]
    assert code == 0, err[-4000:]
    cell = small_cell(WORKLOAD)
    config = dict(cell.config, cards=D)
    floor = counts_sharded.floor_bytes(
        config, traffic.make_batch(config, cell.traffic, SEED, 0))
    assert floor > 0
    steps = records["bytes"]
    assert len(steps) > run.AGREE_STEPS
    for counts in steps:
        assert all(counts[k] > 0 for k in ("all-to-all", "reduce-scatter",
                                           "all-gather", "all-reduce"))
        assert sum(counts.values()) >= floor, (counts, floor)
    # The one-rank run sends nothing.
    assert all(sum(c.values()) == 0 for c in runs["d1"][3]["bytes"])


def _record(ops, steps=2):
    cell = small_cell(WORKLOAD)
    trace = Trace(ops=ops, busy_s=1.0, window_s=1.0, steps=steps, gaps=[])
    batches = [traffic.make_batch(cell.config, cell.traffic, SEED, i)
               for i in range(steps)]
    return RunRecord(config=cell.config, traffic=cell.traffic, steps=10,
                     wall_s=1.0, enqueue_s=[0.01], wait_s=[0.001],
                     trace=trace, profiled_batches=batches), batches


def test_the_exchange_readers_on_a_synthetic_trace():
    ops = [("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", 0.0, 300.0),
           ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 500.0, 100.0),
           ("apply_scatter_row_blocks_kernel", 700.0, 2000.0)]
    record, batches = _record(ops)
    ms = metric_reader("collective_ms").read(record)
    assert ms == pytest.approx(0.4 / 2)  # 400 us over 2 steps
    pct = metric_reader("collective_nvlink_pct").read(record)
    floor = sum(counts_sharded.floor_s(record.config, b) for b in batches)
    assert pct == pytest.approx(100 * floor / 400e-6)


@pytest.mark.parametrize("ops", [[], [("apply_scatter_row_blocks_kernel",
                                       0.0, 10.0)]], ids=["empty", "one_card"])
def test_the_exchange_readers_read_none_without_nccl(ops):
    record, _ = _record(ops)
    for name in ("collective_ms", "collective_nvlink_pct"):
        assert metric_reader(name).read(record) is None
        record_without = RunRecord(config=record.config,
                                   traffic=record.traffic, steps=10,
                                   wall_s=1.0, enqueue_s=[], wait_s=[])
        assert metric_reader(name).read(record_without) is None
