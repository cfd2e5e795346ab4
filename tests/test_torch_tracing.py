"""The spans and counters of the port's training step (utils/tracing.py),
on the CPU: a small DLRMDCNv2 in device-COO mode, in the packed layout
(f32 tables + Adagrad) and in capacity mode (bf16 tables, row-wise
Adagrad, split layout, stochastic rounding)."""

from __future__ import annotations

import json
import logging
import threading

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch.data.criteo import CriteoDataset
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils import tracing

CFG = configs.smoke_test(embedding_dim=128, global_batch_size=64,
                         vocab_sizes=[3000, 2000, 100, 50, 2500, 30],
                         embedding_threshold=1000)
LAYOUTS = {"packed": ("float32", "adagrad"),
           "capacity": ("bfloat16", "rowwise_adagrad")}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _model(layout: str, max_unique: int | None = None) -> DLRMDCNv2:
    dc = mlperf.model_config(CFG)
    dc.table_dtype, dc.embedding_optimizer = LAYOUTS[layout]
    if max_unique is not None:
        dc.max_unique_ids_per_partition = max_unique
    return DLRMDCNv2(dc, generator=torch.Generator().manual_seed(0),
                     device="cpu")


def _batches(n: int, seed: int = 5) -> list[dict]:
    ds = CriteoDataset(None, global_batch_size=CFG.global_batch_size,
                       vocab_sizes=CFG.vocab_sizes,
                       multi_hot_sizes=CFG.multi_hot_sizes)
    return list(ds.dummy_batches(n, seed=seed))


def _train(model: DLRMDCNv2, batches: list[dict]) -> list[torch.Tensor]:
    step = make_train_step(model, mlperf.make_loss_fn(True),
                           DenseAdagrad(model.parameters(),
                                        CFG.learning_rate))
    return [step(model.to_device(b)) for b in batches]


def _traced(layout: str, n: int = 1, **kw) -> tuple[DLRMDCNv2, list]:
    model = _model(layout, **kw)
    batches = _batches(n)
    tracing.enable()
    _train(model, batches)
    tracing.disable()
    return model, batches


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_span_tree_of_one_step(layout):
    model, _ = _traced(layout)
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    [root] = [s for s in spans if s.name == "step"]
    assert root.parent is None and root.step == 0
    assert {s.step for s in spans} == {0}
    n_stacks = len(model.embedding_layer.stacks)
    names = sorted(s.name for s in spans)
    want = (["embedding.coo"] * (1 + n_stacks)
            + ["embedding.lookup"] * n_stacks
            + ["embedding.update"] * n_stacks
            + ["step", "step.backward", "step.forward", "step.optimizer"])
    assert names == sorted(want)

    def parent(s):
        return by_id[s.parent].name

    for s in spans:
        if s.name in ("step.forward", "step.backward", "step.optimizer"):
            assert parent(s) == "step"
        elif s.name == "embedding.coo":
            assert parent(s) == ("embedding.coo" if "stack" in s.attrs
                                 else "step.forward")
        elif s.name == "embedding.lookup":
            assert parent(s) == "step.forward"
        elif s.name == "embedding.update":
            assert parent(s) == "step.backward"
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        children = [c for c in spans if c.parent == s.id]
        assert s.end_ns - s.start_ns >= sum(c.end_ns - c.start_ns
                                            for c in children)
    stacks = {st.name for st in model.embedding_layer.stacks}
    for name in ("embedding.lookup", "embedding.update"):
        assert {s.attrs["stack"] for s in spans if s.name == name} == stacks


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_counters_of_three_steps(layout):
    model, batches = _traced(layout, n=3)
    got = tracing.counters()
    large = [f"cat_{i}" for i in model.large_idx]
    assert got["embedding.ids"] == sum(np.asarray(b[k]).size
                                       for b in batches for k in large)
    assert got["embedding.unique_rows"] == sum(
        np.unique(np.asarray(b[k])).size for b in batches for k in large)
    assert got["embedding.dropped_ids"] == 0
    # Read once, the counters stay until reset.
    assert tracing.counters() == got


def test_dropped_ids_sum_the_device_stats():
    model, batches = _traced("packed", n=3, max_unique=200)
    layer = model.embedding_layer
    want = 0
    for b in batches:
        raw = model.to_device(b)
        _, stats = layer.preprocess_on_device(
            {f"cat_{i}": raw[f"cat_{i}"] for i in model.large_idx},
            return_stats=True)
        want += sum(int(st.dropped_ids) for st in stats.values())
    assert want > 0
    assert tracing.counters()["embedding.dropped_ids"] == want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_host_sync_spans_per_step(layout):
    """No layout reads the device on the host inside a step: the bf16
    stacks draw their rounding bits from the step on the device."""
    model, _ = _traced(layout, n=2)
    syncs = [s for s in tracing.spans() if s.name == "host_sync"]
    bf16 = sum(st.storage_dtype == torch.bfloat16
               for st in model.embedding_layer.stacks)
    assert syncs == []
    assert (bf16 > 0) == (layout == "capacity")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_split_fused_rows_count_the_unique_rows_of_capacity(layout):
    """The fused split update (bf16 + row-wise Adagrad) updates every
    unique row of the capacity stacks; packed stacks never reach it."""
    _traced(layout, n=3)
    got = tracing.counters()
    if layout == "capacity":
        assert got["embedding.split_fused_rows"] == got[
            "embedding.unique_rows"] > 0
    else:
        assert "embedding.split_fused_rows" not in got
        assert got["embedding.unique_rows"] > 0


def test_tracing_off_records_nothing():
    model = _model("capacity")
    _train(model, _batches(2))
    assert tracing.spans() == []
    assert tracing.counters() == {}
    assert tracing.span("step") is tracing.span("embedding.coo", stack="s")
    tracing.count("embedding.ids", 5)
    assert tracing.counters() == {}


def _state(model: DLRMDCNv2) -> list[torch.Tensor]:
    out = [p.detach().clone() for p in model.parameters()]
    layer = model.embedding_layer
    for i in range(len(layer.stacks)):
        st = layer.stack_state(i)
        out.append(st["table"].clone())
        out.extend(v.clone() for v in st.get("slots", {}).values())
        out.append(st["step"].clone())
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tracing_on_changes_no_bit(layout):
    batches = _batches(3)
    runs = []
    for on in (False, True):
        model = _model(layout)
        if on:
            tracing.enable()
        losses = _train(model, batches)
        tracing.disable()
        runs.append((losses, _state(model)))
    (l_off, s_off), (l_on, s_on) = runs
    assert [x.item() for x in l_off] == [x.item() for x in l_on]
    assert len(s_off) == len(s_on)
    for a, b in zip(s_off, s_on):
        assert torch.equal(a, b)
    assert len({s.step for s in tracing.spans()}) == 3


def test_profiler_holds_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model = _model("capacity")
    batches = _batches(1)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(model, batches)
    tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {s.name for s in tracing.spans()} <= got
    assert {"step", "step.forward", "embedding.update",
            "embedding.lookup"} <= got


def test_a_thread_without_open_spans_parents_to_the_step_thread():
    tracing.enable()
    seen = []

    def other():
        with tracing.span("embedding.update", stack="s"):
            pass
        seen.append(True)

    with tracing.span("step"):
        with tracing.span("step.backward"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen
    # Outside a step a span has no step and no parent.
    with tracing.span("loader.to_device"):
        pass
    by_name = {s.name: s for s in tracing.spans()}
    update = by_name["embedding.update"]
    assert update.parent == by_name["step.backward"].id
    assert update.step == by_name["step"].step == 0
    assert update.thread != by_name["step"].thread
    assert by_name["loader.to_device"].parent is None
    assert by_name["loader.to_device"].step is None


def test_counters_add_host_ints_and_device_tensors():
    tracing.enable()
    tracing.count("a", 3)
    tracing.count("a", 4)
    tracing.count("b", torch.tensor([2], dtype=torch.int32))
    tracing.count("b", torch.tensor(5, dtype=torch.int32))
    tracing.disable()
    tracing.count("a", 100)
    assert tracing.counters() == {"a": 7, "b": 7}


def test_loader_traces_its_move_to_the_device():
    from keras_rs_tpu_torch.data.loader import ThreadedDataLoader

    tracing.enable()
    with ThreadedDataLoader(iter(range(3)), lambda x: x,
                            transfer_fn=lambda x: x + 1,
                            num_workers=1) as loader:
        got = list(loader)
    assert sorted(got) == [1, 2, 3]
    assert [s.name for s in tracing.spans()] == ["loader.to_device"] * 3


def test_main_device_mode_warns_of_every_steps_drops(caplog):
    """The warning every 100 steps reads the dropped-id counter, so it
    counts every step's drops; main leaves tracing as it found it."""
    with caplog.at_level(logging.WARNING, logger="ml_perf"):
        mlperf.main("smoke_test", device="cpu", num_steps=100,
                    device_preprocessing=True, device_unique_factor=0,
                    num_loader_threads=1)
    assert not tracing.enabled()
    msgs = [r.getMessage() for r in caplog.records
            if "dropped" in r.getMessage()]
    assert len(msgs) == 1 and "by step 100" in msgs[0]
    dropped = int(msgs[0].split("dropped ")[1].split()[0])
    assert dropped == tracing.counters()["embedding.dropped_ids"] > 0


def test_main_profile_trace_holds_the_spans(tmp_path):
    mlperf.main("smoke_test", device="cpu", num_steps=22,
                do_profile=True, profile_dir=str(tmp_path))
    assert not tracing.enabled()
    [trace] = list(tmp_path.iterdir())
    events = json.loads(trace.read_text())["traceEvents"]
    steps = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "step"]
    assert len(steps) == 11  # steps 10 to 20
