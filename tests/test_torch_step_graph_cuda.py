"""The one-card training step replayed as a CUDA graph
(training/train_state.StepGraph) against the same step run eagerly
(`step.graphs.body`), on the card. Skips without a CUDA device; imports
no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_step_graph_cuda.py

A small DLRMDCNv2 in device-COO mode, packed (f32 tables + Adagrad,
kernel B1) and capacity (bf16 tables, row-wise Adagrad: the split kernel
and B3). From one state, six graphed steps and six eager ones: bit for
bit under deterministic algorithms (losses, every parameter, buffer and
accumulator, step counters included, and tracing's counters); without
them, each loss within twice the gap between two eager runs (or 1e-5 of
it). A kernel's launch count counts its wrapper's calls: those of the
three calls that ran the step's Python (eager, warm, capturing).
"""

from __future__ import annotations

import pytest
import torch

from keras_rs_tpu_torch.data.criteo import CriteoDataset
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.layers.embedding.preprocessing import InputStats
from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2, bce_loss
from keras_rs_tpu_torch.ops import row_ops
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    StepGraph,
    make_train_step,
)
from keras_rs_tpu_torch.utils import tracing

CFG = configs.smoke_test(embedding_dim=128, global_batch_size=1024,
                         vocab_sizes=[300_000, 200_000, 100, 50, 250_000,
                                      30],
                         embedding_threshold=1000)
LAYOUTS = {"packed": ("float32", "adagrad"),
           "capacity": ("bfloat16", "rowwise_adagrad")}
STEPS = 6
GRAPH_COUNTERS = ("step.graph_captures", "step.graph_replays",
                  "step.graph_eager")
ROW_KERNELS = ("apply_scatter_row_blocks", "scatter_row_blocks",
               "scatter_rows", "_scatter_rows_multi", "apply_split_rows",
               "round_split_rows")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.reset()
    was = torch.are_deterministic_algorithms_enabled()
    yield
    torch.use_deterministic_algorithms(was)
    tracing.disable()
    tracing.reset()


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)


def _raws(n: int, seed: int = 5) -> list[dict]:
    ds = CriteoDataset(None, global_batch_size=CFG.global_batch_size,
                       vocab_sizes=CFG.vocab_sizes,
                       multi_hot_sizes=CFG.multi_hot_sizes)
    return list(ds.dummy_batches(n, seed=seed))


def _build(layout: str, dev, loss_fn=None, has_aux=False):
    dc = mlperf.model_config(CFG)
    dc.table_dtype, dc.embedding_optimizer = LAYOUTS[layout]
    model = DLRMDCNv2(dc, generator=torch.Generator(dev).manual_seed(0),
                      device=dev)
    opt = DenseAdagrad(model.parameters(), CFG.learning_rate)
    step = make_train_step(model, loss_fn or mlperf.make_loss_fn(True),
                           opt, has_aux=has_aux)
    return model, opt, step


def _state(model, opt) -> list[torch.Tensor]:
    return ([p.detach().clone() for p in model.parameters()]
            + [b.clone() for b in model.buffers()]
            + [a.clone() for a in opt.accumulators])


def _launches() -> dict[str, int]:
    return {name: getattr(row_ops, name).launches for name in ROW_KERNELS}


def _run(layout, dev, graphed, raws, loss_fn=None, has_aux=False,
         between=None):
    """(outputs, state, counters without the graph's, graph counters,
    launches) of len(raws) steps from the seed's state, graphed or eager;
    `between(model)` runs after the first half of the steps."""
    model, opt, step = _build(layout, dev, loss_fn, has_aux)
    run = step if graphed else step.graphs.body
    tracing.reset()
    tracing.enable()
    before = _launches()
    totals = dict(StepGraph.totals)
    outs = []
    for i, raw in enumerate(raws):
        if between is not None and i == len(raws) // 2:
            between(model)
        outs.append(run(model.to_device(raw)))
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in _launches().items()}
    counters = tracing.counters()
    tracing.disable()
    graph = {k: counters.pop(k, 0) for k in GRAPH_COUNTERS}
    # StepGraph.totals counts what the tracing counters count.
    assert graph == {f"step.graph_{k}": StepGraph.totals[k] - totals.get(k, 0)
                     for k in ("captures", "replays", "eager")}
    return outs, _state(model, opt), counters, graph, launched


def _equal(a: list[torch.Tensor], b: list[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_graphed_steps_equal_eager_steps_bit_for_bit(cuda, deterministic,
                                                      layout):
    raws = _raws(STEPS)
    g_losses, g_state, g_counts, graph, g_launched = _run(
        layout, cuda, True, raws)
    e_losses, e_state, e_counts, eager, e_launched = _run(
        layout, cuda, False, raws)
    assert _equal(g_losses, e_losses), (g_losses, e_losses)
    assert _equal(g_state, e_state)
    # The replays added what the capture counted: ids, unique rows and
    # drops, on the host and on the device.
    assert g_counts == e_counts and g_counts["embedding.ids"] > 0
    # The kernels launched in every replay (the state above, step
    # counters included); their wrappers ran in the first three calls.
    assert any(e_launched.values())
    assert g_launched == {k: n // STEPS * 3 for k, n in e_launched.items()}
    # Eager, eager on the capture stream, the capture and its replay,
    # three replays.
    assert graph == {"step.graph_captures": 1,
                     "step.graph_replays": STEPS - 2,
                     "step.graph_eager": 2}
    assert eager == dict.fromkeys(GRAPH_COUNTERS, 0)
    # Each step returned a loss of its own, which later replays left be.
    assert len({x.data_ptr() for x in g_losses}) == STEPS
    assert not any(x.requires_grad for x in g_losses)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_graphed_steps_within_the_spread_of_eager_runs(cuda, layout):
    raws = _raws(STEPS, seed=9)
    graphed = _run(layout, cuda, True, raws)[0]
    a, b = (_run(layout, cuda, False, raws)[0] for _ in range(2))
    for g, x, y in zip(graphed, a, b):
        bound = max(2 * abs(float(y) - float(x)), 1e-5 * abs(float(x)))
        assert abs(float(g) - float(x)) <= bound, (graphed, a, b)


@pytest.mark.cuda
def test_aux_is_cloned_every_step(cuda, deterministic):
    def loss_fn(m, b):
        pre = m.preprocess_on_device(b)
        logits = m(pre)
        return bce_loss(m, pre), {"logits": logits}

    raws = _raws(STEPS)
    g = _run("packed", cuda, True, raws, loss_fn, has_aux=True)
    e = _run("packed", cuda, False, raws, loss_fn, has_aux=True)
    assert _equal([o[0] for o in g[0]], [o[0] for o in e[0]])
    assert _equal([o[1]["logits"] for o in g[0]],
                  [o[1]["logits"] for o in e[0]])
    assert len({o[1]["logits"].data_ptr() for o in g[0]}) == STEPS
    assert g[3]["step.graph_replays"] == STEPS - 2


@pytest.mark.cuda
def test_a_moved_table_is_captured_again(cuda, deterministic):
    def move(model):
        layer = model.embedding_layer
        layer.stack0_table = layer.stack0_table.clone()

    raws = _raws(8)
    g = _run("packed", cuda, True, raws, between=move)
    e = _run("packed", cuda, False, raws, between=move)
    assert _equal(g[0], e[0]) and _equal(g[1], e[1])
    assert g[3] == {"step.graph_captures": 2, "step.graph_replays": 4,
                    "step.graph_eager": 4}


@pytest.mark.cuda
def test_a_host_read_in_the_loss_falls_back_to_eager(cuda, deterministic):
    def loss_fn(m, b):
        loss = bce_loss(m, m.preprocess_on_device(b))
        if not loss.item() >= 0.0:  # a host read: no graph can hold it
            raise ValueError("negative loss")
        return loss

    raws = _raws(STEPS)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        g = _run("packed", cuda, True, raws, loss_fn)
    e = _run("packed", cuda, False, raws, loss_fn)
    assert _equal(g[0], e[0]) and _equal(g[1], e[1])
    assert g[2] == e[2] and g[4] == e[4]
    assert g[3] == {"step.graph_captures": 0, "step.graph_replays": 0,
                    "step.graph_eager": STEPS}


@pytest.mark.cuda
def test_replays_read_nothing_back(cuda):
    """Once captured, a step reads no value on the host: only the wait
    for the replay two steps back, an event, stands between steps."""
    model, _, step = _build("capacity", cuda)
    batches = [model.to_device(r) for r in _raws(8)]
    for b in batches[:3]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [step(b) for b in batches[3:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(x) for x in losses)


@pytest.mark.cuda
def test_rebuilt_capacities_are_captured_again(cuda, deterministic):
    """A rebuild changes no tensor of the model: the graph of the old
    capacities must not replay (it would drop what the new ones keep)."""

    def rebuild(model):
        layer = model.embedding_layer
        stack = layer.stacks[0]
        assert layer.rebuild_capacities(synced={stack.name: InputStats(
            max_ids_per_bucket=stack.max_ids_per_partition + 64,
            max_unique_per_shard=stack.max_unique_ids_per_shard + 64,
            dropped_ids=0)})

    raws = _raws(8)
    g = _run("packed", cuda, True, raws, between=rebuild)
    e = _run("packed", cuda, False, raws, between=rebuild)
    assert _equal(g[0], e[0]) and _equal(g[1], e[1])
    assert g[3] == {"step.graph_captures": 2, "step.graph_replays": 4,
                    "step.graph_eager": 4}


def _segments_of(pool) -> list[dict]:
    """The allocator's segments of the graph memory pool `pool`."""
    return [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg["segment_pool_id"]) == tuple(pool)]


@pytest.mark.cuda
def test_dropping_the_step_frees_the_graph_memory(cuda):
    """The graph allocated the gradients in its memory pool: dropping the
    step drops them, and the pool goes back to the card."""
    model, opt, step = _build("packed", cuda)
    for r in _raws(4):
        step(model.to_device(r))
    torch.cuda.synchronize()
    pool = step.graphs._graph.graph.pool()
    assert _segments_of(pool)
    assert all(p.grad is not None for p in opt.params)
    del step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert all(p.grad is None for p in opt.params)
    assert not _segments_of(pool)
