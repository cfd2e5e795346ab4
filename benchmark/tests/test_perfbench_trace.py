"""The trace reduction and the per-layer readers on a made-up trace."""

import pytest

from benchmark import counts, trace
from benchmark.record import RunRecord
from benchmark.spec import load_cell, metric_reader


def _events():
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                               "ts": ts, "dur": dur}
    return [
        {"ph": "X", "cat": "user_annotation", "name": "bench.train_step",
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 150.0,
         "dur": 200.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 160.0, "dur": 140.0},
        k("gemm", 0.0, 100.0),
        k("apply_scatter_row_blocks_kernel<Adagrad>", 50.0, 100.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400.0,
         "dur": 100.0},
        k("apply_scatter_row_blocks_kernel<Adagrad>", 900.0, 100.0),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.train_step",
         "ts": 0.0, "dur": 1000.0},
    ]


def test_reduce_busy_union_gaps_and_labels():
    t = trace.reduce(_events(), window_s=2e-3, steps=2)
    # [0, 150) + [400, 500) + [900, 1000)
    assert t.busy_s == pytest.approx(350e-6)
    assert [round(s * 1e6) for _, s in t.gaps] == [400, 250]
    assert t.gaps[0][0] == "train_step: idle host"
    assert t.gaps[1][0] == "train_step: cudaStreamSynchronize"
    assert t.seconds_of("apply_scatter_row_blocks_kernel") == pytest.approx(
        200e-6)
    assert t.seconds_of("no such kernel") is None
    assert t.top_ops()[0][0] == "apply_scatter_row_blocks_kernel<Adagrad>"


def _record(workload, with_trace=True):
    cell = load_cell(workload)
    batch = {f"cat_{i}": [[i]] for i in range(26)}
    return cell, RunRecord(
        config=cell.config, traffic=cell.traffic, steps=10, wall_s=0.5,
        enqueue_s=[0.01, 0.03], wait_s=[0.002, 0.004],
        trace=trace.reduce(_events(), 2e-3, 2) if with_trace else None,
        profiled_batches=[batch, batch])


def test_readers_of_a_packed_cell():
    cell, run = _record("dlrm-packed.multihot")
    read = {m["name"]: metric_reader(m["name"]).read(run)
            for m in cell.per_layer}
    assert set(read) == {"host_enqueue_ms", "batch_wait_ms",
                         "device_idle_pct", "step_mfu_pct",
                         "b1_roofline_pct"}
    assert read["host_enqueue_ms"] == pytest.approx(20.0)
    assert read["batch_wait_ms"] == pytest.approx(3.0)
    # 175 us busy per step against 50 ms of wall time per step.
    assert read["device_idle_pct"] == pytest.approx(
        100 * (1 - 175e-6 / 50e-3))
    assert read["step_mfu_pct"] == pytest.approx(
        100 * counts.dense_flops_per_step(cell.config) * 10 / 0.5 / 989e12)
    rows = 2 * 9  # one id in each large table, two batches
    assert read["b1_roofline_pct"] == pytest.approx(
        100 * rows * 2564 / 3.35e12 / 200e-6)


def test_readers_find_nothing_without_a_trace():
    cell, run = _record("dlrm-capacity.multihot", with_trace=False)
    assert metric_reader("b3_roofline_pct").read(run) is None
    assert metric_reader("device_idle_pct").read(run) is None
    assert metric_reader("host_enqueue_ms").read(run) == pytest.approx(20.0)


def test_b3_reader_finds_nothing_when_its_kernel_did_not_run():
    cell, run = _record("dlrm-capacity.multihot")
    assert metric_reader("b3_roofline_pct").read(run) is None
