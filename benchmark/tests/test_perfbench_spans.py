"""spans.py's reductions on hand-made spans and a hand-made Chrome trace:
self times, device time by the innermost launching span (a second
thread's launch, a launch outside any span), the idle gaps' labels and
the per-layer metrics."""

from collections import namedtuple

import pytest

from benchmark import spans

S = namedtuple("S", "name step id parent thread start_ns end_ns attrs")


def _spans():
    # One step on thread 1; the update runs on thread 2, its parent the
    # step's open backward; a child that outlasts its parent is clipped.
    return [
        S("step", 0, 0, None, 1, 0, 1000, {}),
        S("step.forward", 0, 1, 0, 1, 0, 400, {}),
        S("embedding.coo", 0, 2, 1, 1, 10, 100, {}),
        S("embedding.coo", 0, 3, 2, 1, 50, 90, {"stack": "a"}),
        S("step.backward", 0, 4, 0, 1, 400, 800, {}),
        S("embedding.update", 0, 5, 4, 2, 500, 600, {"stack": "a"}),
        S("host_sync", 0, 6, 5, 2, 550, 700, {"site": "rounding_seed"}),
        S("step.optimizer", 0, 7, 0, 1, 800, 1000, {}),
        S("loader.to_device", None, 8, None, 1, 1100, 1130, {}),
    ]


def test_self_times():
    got = spans.self_times(_spans())
    assert got == {"step": 0, "step.forward": 310, "embedding.coo": 90,
                   "step.backward": 300, "embedding.update": 50,
                   "host_sync": 150, "step.optimizer": 200,
                   "loader.to_device": 30}
    assert all(v >= 0 for v in got.values())


def _x(cat, name, tid, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts,
         "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    ann = lambda name, tid, ts, dur: _x("user_annotation", name, tid, ts,
                                        dur)
    launch = lambda tid, ts, corr: _x("cuda_runtime", "cudaLaunchKernel",
                                      tid, ts, 2, corr)
    return [
        ann("step", 1, 0, 1000), ann("step.forward", 1, 0, 400),
        ann("embedding.coo", 1, 10, 90), ann("step.backward", 1, 400, 400),
        ann("step.optimizer", 1, 800, 200),
        ann("embedding.update", 2, 500, 100),
        launch(1, 20, 1), launch(1, 200, 2), launch(2, 550, 3),
        launch(2, 700, 4), _x("cuda_runtime", "cudaMemcpyAsync", 1, 900,
                              2, 5),
        launch(1, 1200, 6),
        _x("kernel", "sort", "stream 7", 100, 30, 1),
        _x("kernel", "gemm", "stream 7", 300, 50, 2),
        _x("kernel", "apply_scatter_row_blocks_kernel", "stream 7", 560, 40,
           3),
        _x("kernel", "index_add", "stream 7", 720, 60, 4),
        _x("gpu_memcpy", "Memcpy HtoD", "stream 7", 950, 10, 5),
        _x("kernel", "after", "stream 7", 1300, 25, 6),
        _x("gpu_memset", "Memset", "stream 7", 1400, 5),
        _x("gpu_user_annotation", "step", "stream 7", 0, 1000),
    ]


def test_device_time_by_innermost_launching_span():
    d = spans.DeviceTimes(_events())
    assert d.by_span == {"embedding.coo": 30, "step.forward": 50,
                         "embedding.update": 40, "step.backward": 60,
                         "step.optimizer": 10}
    assert d.unattributed_us == 30 and d.total_us == 220
    assert d.coverage == pytest.approx(190 / 220)
    assert d.gaps == [("outside any span", 340), ("step.backward", 210),
                      ("step.forward", 170), ("step.optimizer", 170),
                      ("step.backward", 120), ("outside any span", 75)]


def test_metrics_per_step():
    counters = {"embedding.ids": 200, "embedding.unique_rows": 150}
    got = spans.metrics(_spans(), 2, counters, spans.DeviceTimes(_events()),
                        2)
    assert got == pytest.approx({
        "coo_host_ms": 45e-6, "lookup_host_ms": 0.0,
        "dense_host_ms": 305e-6, "update_host_ms": 25e-6,
        "optimizer_host_ms": 100e-6, "host_sync_ms": 75e-6,
        "to_device_ms": 15e-6,
        "coo_device_ms": 15e-3, "lookup_device_ms": 0.0,
        "dense_device_ms": 55e-3, "update_device_ms": 20e-3,
        "optimizer_device_ms": 5e-3, "unique_row_share": 0.75})


def test_metrics_without_a_profile_or_counters():
    got = spans.metrics(_spans(), 1, {})
    assert "coo_device_ms" not in got and "unique_row_share" not in got
    assert got["dense_host_ms"] == pytest.approx(610e-6)


@pytest.mark.parametrize("workload", ["dlrm-packed.multihot",
                                      "dlrm-capacity.multihot"])
def test_measure_rehearses_a_small_cell_on_the_cpu(workload):
    import torch

    from benchmark.tests.small import small_cell

    got = spans.measure(small_cell(workload), 2147483911, 0.3,
                        torch.device("cpu"))
    m = got["metrics"]
    assert not any(f"{k}_device_ms" in m for k in spans.DEVICE_LAYERS)
    assert "device_coverage" not in got
    assert got["counters"]["embedding.unique_rows"] == got[
        "unique_rows_of_the_batches"]
    assert m["unique_row_share"] == pytest.approx(
        got["unique_rows_of_the_batches"] / got["counters"]["embedding.ids"])
    assert got["counters"]["embedding.dropped_ids"] == 0
    # No step reads a value back to the host in either layout: the split
    # update draws its rounding bits from the step on the device.
    assert m["host_sync_ms"] == 0
    assert m["to_device_ms"] > 0 and m["dense_host_ms"] > 0
    assert 0 < got["step_layers_host_ms"] <= got["step_span_ms"]
