"""The pipelined embedding step's side stream on the card
(keras_rs_tpu_torch/training/pipelined.py). Skips without a CUDA device;
imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_pipelined_cuda.py

The reference run is the same step with its prefetch on the main stream
(`torch.cuda.Stream` replaced by the current stream, so every kernel
runs in program order). Bounds: bit for bit, losses, prefetched
activations and final state, over 20 steps. Both runs take PyTorch's
deterministic algorithms (warn_only: `index_add_`, which sums the
lookup's gradients by row, otherwise adds with atomics in a
data-dependent order on CUDA); B1 and the row scatter write each row
once. The stress case checks every step's prefetch against a gather of
the same tables on the main stream, bit for bit, while the main stream
allocates, fills with NaN and frees tensors of the activations' size
between steps (memory the caching allocator would hand out if a tensor
still in use by the other stream were not marked with record_stream).
"""

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models import dlrm
from keras_rs_tpu_torch.training import pipelined, train_state

B = 256
VOCAB = [20_000, 15_000, 50, 9_000]
MULTI_HOT = [3, 2, 1, 4]
LAYOUTS = {
    "packed": dict(),
    "split": dict(embedding_optimizer="rowwise_adagrad"),
    "split_bf16": dict(table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(before)


def _model(device, **overrides):
    kw = dict(vocab_sizes=VOCAB, multi_hot_sizes=MULTI_HOT,
              num_dense_features=13, embedding_dim=128,
              bottom_mlp=(64, 128), top_mlp=(64, 32, 1), num_dcn_layers=2,
              dcn_projection_dim=32, embedding_threshold=1000,
              max_ids_per_partition=B * 9, max_unique_ids_per_partition=B * 9,
              learning_rate=0.05, global_batch_size=B,
              table_placement="sharded", compute_dtype=None,
              dense_output_dtype="float32")
    kw.update(overrides)
    return dlrm.DLRMDCNv2(dlrm.DLRMConfig(**kw), device=device,
                          generator=torch.Generator(device).manual_seed(0))


def _raws(n):
    return [synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                        multi_hot_sizes=MULTI_HOT,
                                        seed=100 + i % 7)
            for i in range(n)]


def _run(device, layout, raws, device_preprocessing=False, between=None):
    """(losses, prefetched activations after each step, final state
    dict, main-stream gathers) of one pipelined run. With `between`, a
    gather of each step's next batch is enqueued on the main stream
    before the step, and `between()` runs after it."""
    model = _model(device, **LAYOUTS[layout])
    opt = train_state.DenseAdagrad(model.parameters(), 0.05)
    if device_preprocessing:
        inject = pipelined.dlrm_pipeline_fns()[2]

        def embed_fn(m, raw):
            return m.embedding_layer, m.embedding_layer.preprocess_on_device(
                raw)

        def get_pre(b):
            return {f"cat_{i}": b[f"cat_{i}"] for i in model.large_idx}

        batches = [model.to_device(r) for r in raws]
    else:
        embed_fn, get_pre, inject = pipelined.dlrm_pipeline_fns()
        batches = [model.preprocess(r) for r in raws]
    state = pipelined.create_pipelined_train_state(
        model, opt, get_pre(batches[0]), embed_fn)
    step = pipelined.make_pipelined_train_step(
        dlrm.bce_loss, opt, embed_fn, get_pre, inject)
    losses, acts, refs = [], [], []
    for t, batch in enumerate(batches):
        nxt = get_pre(batches[min(t + 1, len(batches) - 1)])
        if between is not None:
            refs.append(pipelined.prime(model, nxt, embed_fn).acts)
        state, loss = step(state, batch, nxt)
        if between is not None:
            between()
        losses.append(loss)
        acts.append({k: v.clone() for k, v in state.prefetched.acts.items()})
    torch.cuda.synchronize(device)
    return ([float(x) for x in losses], acts,
            {k: v.clone() for k, v in model.state_dict().items()}, refs)


class _MainStreamCuda:
    """torch.cuda, but `Stream(device)` gives the current stream."""

    def __getattr__(self, name):
        return getattr(torch.cuda, name)

    @staticmethod
    def Stream(device):
        return torch.cuda.current_stream(device)


class _MainStreamTorch:
    """torch, with the torch.cuda of `_MainStreamCuda` (seen by the
    pipelined module alone)."""

    cuda = _MainStreamCuda()

    def __getattr__(self, name):
        return getattr(torch, name)


def _main_stream_only(monkeypatch):
    monkeypatch.setattr(pipelined, "torch", _MainStreamTorch())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_side_stream_equals_main_stream(cuda, deterministic, monkeypatch,
                                        layout):
    raws = _raws(20)
    side = _run(cuda, layout, raws)
    _main_stream_only(monkeypatch)
    main = _run(cuda, layout, raws)
    assert side[0] == main[0]
    assert np.isfinite(side[0]).all()
    for a, b in zip(side[1], main[1]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in side[2]:
        assert torch.equal(side[2][k], main[2][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("device_preprocessing", [False, True],
                         ids=["host_coo", "device_coo"])
def test_stress_prefetch_against_main_stream_gathers(cuda,
                                                     device_preprocessing):
    raws = _raws(120)

    def between():
        # Memory freed on the main stream and refilled at once, with no
        # host sync: a block the side stream still used would show NaN.
        for n in (B * 128, B * 128 * 2, B * 128 * len(VOCAB)):
            torch.empty(n, device=cuda).fill_(float("nan"))

    losses, acts, _, refs = _run(cuda, "packed", raws, device_preprocessing,
                                 between)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for got, want in zip(acts, refs):
        for k in want:
            assert torch.equal(got[k], want[k]), k
