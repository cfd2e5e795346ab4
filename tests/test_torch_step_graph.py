"""When the one-card training step is replayed as a CUDA graph
(training/train_state.StepGraph), on the CPU: the rule that engages it,
which reads only what a call can observe, and the eager step, which the
CPU always runs. The graph itself runs on the card
(tests/test_torch_step_graph_cuda.py)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch import nn

from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    DenseAdam,
    StepGraph,
    make_train_step,
)
from keras_rs_tpu_torch.layers.embedding.preprocessing import InputStats
from keras_rs_tpu_torch.utils import cuda_graph, tracing

CFG = configs.smoke_test(embedding_dim=128, global_batch_size=64,
                         vocab_sizes=[3000, 2000, 100, 50, 2500, 30],
                         embedding_threshold=1000)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


class _Net(nn.Module):
    def __init__(self) -> None:
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = nn.Parameter(torch.randn(4, 3, generator=g))
        self.register_buffer("calls", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.calls.add_(1.0)
        return x @ self.w


def _loss(m: _Net, b: dict) -> torch.Tensor:
    return ((m(b["x"]) - b["y"]) ** 2).mean() * b.get("scale", 1.0)


def _batch(n: int = 8, seed: int = 0, **extra) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(n, 4, generator=g),
            "y": torch.randn(n, 3, generator=g), **extra}


@pytest.fixture
def as_card(monkeypatch):
    """StepGraph takes the CPU for a card: its signature and plan run as
    they would on CUDA."""
    monkeypatch.setattr(StepGraph, "graphable",
                        staticmethod(lambda device: device is not None))


def _graphs(model: nn.Module, opt_cls=DenseAdagrad) -> StepGraph:
    step = make_train_step(model, _loss, opt_cls(model.parameters(), 0.1))
    return step.graphs


def _plans(graphs: StepGraph, batches: list) -> list[str]:
    device = graphs.device()
    out = []
    for b in batches:
        sig = graphs.signature(b, device)
        out.append(graphs.plan(None if sig is None else sig[0]))
    return out


def test_capturable_attributes():
    assert DenseAdagrad.capturable is True
    assert DenseAdam.capturable is False


def test_no_graph_on_the_cpu():
    model = _Net()
    step = make_train_step(model, _loss, DenseAdagrad(model.parameters(),
                                                      0.1))
    assert not StepGraph.graphable(torch.device("cpu"))
    assert StepGraph.graphable(torch.device("cuda", 0))
    assert not StepGraph.graphable(None)
    tracing.enable()
    for _ in range(5):
        step(_batch())
    assert step.graphs.key is None
    assert not any(k.startswith("step.graph") for k in tracing.counters())
    assert [s.name for s in tracing.spans()].count("step.replay") == 0


def test_no_graph_at_more_than_one_rank():
    mesh = types.SimpleNamespace(size=2, axis_names=("data",),
                                 group=lambda axes: None)
    model = _Net()
    step = make_train_step(model, _loss, DenseAdagrad(model.parameters(),
                                                      0.1), mesh=mesh)
    assert step.graphs is None


def test_two_equal_signatures_then_capture_then_replay(as_card):
    graphs = _graphs(_Net())
    plans = _plans(graphs, [_batch(seed=s) for s in range(6)])
    assert plans == ["eager", "warm", "capture", "replay", "replay",
                     "replay"]


def test_none_with_adam(as_card):
    graphs = _graphs(_Net(), DenseAdam)
    assert graphs.signature(_batch(), graphs.device()) is None
    assert _plans(graphs, [_batch()] * 5) == ["eager"] * 5


@pytest.mark.parametrize("change", ["shape", "dtype", "plain value",
                                    "structure", "requires_grad"])
def test_a_new_batch_signature_starts_over(as_card, change):
    graphs = _graphs(_Net())
    other = {"shape": _batch(n=16),
             "dtype": {**_batch(), "y": _batch()["y"].double()},
             "plain value": _batch(scale=2.0),
             "structure": {"y": _batch()["y"], "x": _batch()["x"]},
             "requires_grad": {**_batch(),
                               "x": _batch()["x"].requires_grad_()},
             }[change]
    plans = _plans(graphs, [_batch()] * 4 + [other] * 4 + [_batch()])
    assert plans == (["eager", "warm", "capture", "replay"]
                     + ["eager", "warm", "capture", "replay"]
                     + ["eager"])  # one graph at a time


def test_signatures_must_be_consecutive(as_card):
    graphs = _graphs(_Net())
    a, b = _batch(), _batch(n=16)
    assert _plans(graphs, [a, b] * 4) == ["eager"] * 8
    # A replay in between breaks a run of the other signature too.
    plans = _plans(graphs, [a, a, a, b, b, a, b, b, b])
    assert plans == ["eager", "warm", "capture", "eager", "warm", "replay",
                     "eager", "warm", "capture"]


def test_a_moved_state_tensor_means_a_new_capture(as_card):
    model = _Net()
    graphs = _graphs(model)
    assert _plans(graphs, [_batch()] * 4)[-1] == "replay"
    model.calls = model.calls.clone()  # a buffer at another address
    assert _plans(graphs, [_batch()] * 4) == ["eager", "warm", "capture",
                                              "replay"]
    graphs.optimizer.accumulators[0] = (
        graphs.optimizer.accumulators[0].clone())
    assert _plans(graphs, [_batch()] * 3) == ["eager", "warm", "capture"]
    graphs.optimizer.learning_rate = 0.2
    assert _plans(graphs, [_batch()] * 2) == ["eager", "warm"]


def test_a_grown_dlrm_table_means_a_new_capture(as_card):
    dc = mlperf.model_config(CFG)
    model = DLRMDCNv2(dc, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    step = make_train_step(model, mlperf.make_loss_fn(True),
                           DenseAdagrad(model.parameters(), 0.1))
    graphs = step.graphs
    layer = model.embedding_layer
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
             next(iter(_dlrm_batches(1))).items()}
    assert _plans(graphs, [batch] * 4)[-1] == "replay"
    table = layer.stack0_table
    layer.stack0_table = torch.cat([table, table[:8]])  # more rows
    assert _plans(graphs, [batch] * 2) == ["eager", "warm"]


def test_rebuilt_capacities_mean_a_new_capture(as_card):
    """The device COO takes its shapes from the stacks' capacities, plain
    state that no tensor holds: a rebuild replaces the stacks, and the
    graph of the old capacities is not replayed."""
    dc = mlperf.model_config(CFG)
    model = DLRMDCNv2(dc, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    step = make_train_step(model, mlperf.make_loss_fn(True),
                           DenseAdagrad(model.parameters(), 0.1))
    graphs = step.graphs
    layer = model.embedding_layer
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in
             next(iter(_dlrm_batches(1))).items()}
    assert _plans(graphs, [batch] * 4)[-1] == "replay"
    stack = layer.stacks[0]
    grown = InputStats(max_ids_per_bucket=stack.max_ids_per_partition + 8,
                       max_unique_per_shard=stack.max_unique_ids_per_shard,
                       dropped_ids=0)
    assert layer.rebuild_capacities(synced={stack.name: grown})
    assert layer.graph_key() != graphs.key[4][0]
    assert _plans(graphs, [batch] * 4) == ["eager", "warm", "capture",
                                          "replay"]


def test_the_graph_key_of_a_layer_is_its_stacks():
    model = DLRMDCNv2(mlperf.model_config(CFG),
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    layer = model.embedding_layer
    assert layer.graph_key() == layer.stacks and layer.stacks


@pytest.mark.parametrize("a, b", [
    (torch.zeros(2), torch.zeros(3)),
    (torch.zeros(2), torch.zeros(2, dtype=torch.float64)),
    (torch.zeros(2), torch.zeros(2, device="meta")),
    (1, True),
    (1, 1.0),
    (1, 2),
    ("a", None),
    (object(), object()),
])
def test_leaf_signatures_differ(a, b):
    assert cuda_graph.leaf_signature(a) != cuda_graph.leaf_signature(b)


@pytest.mark.parametrize("leaf", [torch.ones(2, 3), 3, 2.5, True, "x",
                                  None])
def test_leaf_signatures_of_equal_leaves_agree(leaf):
    other = leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
    assert (cuda_graph.leaf_signature(leaf)
            == cuda_graph.leaf_signature(other))


def test_tracing_switches_and_resets_mean_a_new_capture(as_card):
    graphs = _graphs(_Net())
    assert _plans(graphs, [_batch()] * 4)[-1] == "replay"
    tracing.enable()
    assert _plans(graphs, [_batch()] * 4) == ["eager", "warm", "capture",
                                              "replay"]
    tracing.reset()
    assert _plans(graphs, [_batch()] * 2) == ["eager", "warm"]
    tracing.disable()
    assert _plans(graphs, [_batch()]) == ["eager"]


@pytest.mark.parametrize("leaf", ["numpy", "other device", "object"])
def test_leaves_a_graph_cannot_copy_run_eagerly(as_card, leaf):
    graphs = _graphs(_Net())
    value = {"numpy": np.ones(3),
             "other device": torch.ones(3, device="meta"),
             "object": object()}[leaf]
    b = _batch(extra=value)
    assert graphs.signature(b, graphs.device()) is None
    assert _plans(graphs, [b] * 4) == ["eager"] * 4


def test_switches_are_in_the_signature(as_card):
    model = _Net()
    graphs = _graphs(model)
    key = graphs.signature(_batch(), graphs.device())[0]
    model.eval()
    assert graphs.signature(_batch(), graphs.device())[0] != key
    model.train()
    with torch.no_grad():
        assert graphs.signature(_batch(), graphs.device())[0] != key
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert graphs.signature(_batch(), graphs.device())[0] != key
    finally:
        torch.use_deterministic_algorithms(was)
    assert graphs.signature(_batch(), graphs.device())[0] == key


def test_a_broken_capture_stays_eager(as_card):
    graphs = _graphs(_Net())
    graphs.broken = True
    assert _plans(graphs, [_batch()] * 4) == ["eager"] * 4


def _dlrm_batches(n: int, seed: int = 5):
    from keras_rs_tpu_torch.data.criteo import CriteoDataset

    ds = CriteoDataset(None, global_batch_size=CFG.global_batch_size,
                       vocab_sizes=CFG.vocab_sizes,
                       multi_hot_sizes=CFG.multi_hot_sizes)
    return list(ds.dummy_batches(n, seed=seed))


@pytest.mark.parametrize("has_aux", [False, True])
def test_the_eager_cpu_step_is_the_plain_loop(has_aux):
    """On the CPU the step is forward, backward and the optimizer, bit for
    bit as written out, and returns a detached loss (and aux)."""

    def loss_fn(m, b):
        loss = _loss(m, b)
        return (loss, {"pred": m(b["x"])}) if has_aux else loss

    models = [_Net(), _Net()]
    opts = [DenseAdagrad(m.parameters(), 0.1) for m in models]
    step = make_train_step(models[0], loss_fn, opts[0], has_aux=has_aux)
    for s in range(4):
        b = _batch(seed=s)
        got = step(b)
        opts[1].zero_grad()
        want = loss_fn(models[1], b)
        (want[0] if has_aux else want).backward()
        opts[1].step()
        if has_aux:
            assert not got[0].requires_grad
            assert not got[1]["pred"].requires_grad
            assert torch.equal(got[0], want[0].detach())
            assert torch.equal(got[1]["pred"], want[1]["pred"].detach())
        else:
            assert not got.requires_grad
            assert torch.equal(got, want.detach())
        assert torch.equal(models[0].w, models[1].w)
        assert torch.equal(models[0].calls, models[1].calls)
