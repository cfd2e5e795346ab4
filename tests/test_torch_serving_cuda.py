"""The serving path on the card: `serving.aot_compile`'s CUDA graph, the
frozen and int8 layers on CUDA tensors, and an exported artifact's round
trip there. Skips without a CUDA device; imports no JAX, so it runs on a
machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_serving_cuda.py

Tolerances: int8 q, scale and packed words bit-exact between the card and
the CPU; a graph replay and an imported artifact equal to the eager
output on the card; card against CPU activations within 1e-6 relative
(f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch import serving
from keras_rs_tpu_torch.data.ragged import Ragged
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.ops import quant

B = 64
QUANTIZE = [None, "int8", "int8_packed", "int8_fused"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _layer(device):
    t = TableConfig("t", 1000, 128, optimizer="adagrad", combiner="sum",
                    placement="sharded", max_ids_per_partition=B * 8,
                    max_unique_ids_per_partition=B * 8)
    t2 = TableConfig("t2", 300, 32, optimizer="adagrad", combiner="mean",
                     placement="sharded", max_ids_per_partition=B * 8,
                     max_unique_ids_per_partition=B * 8)
    fcs = {"a": FeatureConfig("a", t, (B, 5), (B, 128)),
           "b": FeatureConfig("b", t, (B, 1), (B, 128)),
           "c": FeatureConfig("c", t2, (B, 2), (B, 32))}
    return DistributedEmbedding(
        fcs, generator=torch.Generator(device=device).manual_seed(0),
        device=device)


def _requests(seed, device):
    rng = np.random.default_rng(seed)
    a = Ragged.from_lists([list(rng.integers(0, 1000, rng.integers(1, 6)))
                           for _ in range(B)])
    ids, w = a.to_padded(max_length=5)  # static width for the graph
    batch = {"a": ids, "b": rng.integers(0, 1000, (B, 1)),
             "c": rng.integers(0, 300, (B, 2))}
    weights = {"a": w}
    put = (lambda d: {k: torch.from_numpy(v).to(device)
                      for k, v in d.items()})
    return put(batch), put(weights)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", QUANTIZE)
def test_aot_compile_graph_equals_eager(cuda, quantize):
    frozen = _layer(cuda).freeze(quantize=quantize)
    ids, w = _requests(0, cuda)
    compiled = serving.aot_compile(lambda i, v: frozen(i, v), ids, w)
    assert compiled.graph is not None
    for seed in (1, 2):  # new data through the static buffers
        ids, w = _requests(seed, cuda)
        with torch.no_grad():
            want = frozen(ids, w)
        got = compiled(ids, w)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    short = {k: v[: B // 2] for k, v in ids.items()}
    with pytest.raises(ValueError, match="compiled for"):
        compiled(short, {"a": w["a"][: B // 2]})


@pytest.mark.cuda
def test_frozen_forward_is_sync_free(cuda):
    frozen = _layer(cuda).freeze(quantize="int8_fused")
    ids, w = _requests(3, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            frozen(ids, w)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_capture_of_a_host_read_raises(cuda):
    x = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError):
        serving.aot_compile(lambda t: t * float(t.sum()), x)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", QUANTIZE)
def test_card_freeze_matches_cpu(cuda, quantize):
    layer = _layer(cuda)
    cpu_layer = _layer("cpu")
    cpu_layer.set_embedding_tables(
        {k: v.cpu() for k, v in layer.get_embedding_tables().items()})
    frozen = layer.freeze(quantize=quantize)
    cpu_frozen = cpu_layer.freeze(quantize=quantize)
    for mod, cpu_mod in zip(frozen.table_reducers,
                            cpu_frozen.table_reducers):
        for (name, t), (_, c) in zip(mod.named_buffers(),
                                     cpu_mod.named_buffers()):
            assert torch.equal(t.cpu(), c), name
    ids, w = _requests(4, cuda)
    with torch.no_grad():
        got = frozen(ids, w)
        want = cpu_frozen({k: v.cpu() for k, v in ids.items()},
                          {k: v.cpu() for k, v in w.items()})
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.cuda
def test_packed_words_on_card_equal_cpu(cuda):
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1001, 128), generator=g) * 3
    q, scale = quant.quantize_rows_int8(x)
    cq, cscale = quant.quantize_rows_int8(x.to(cuda))
    assert torch.equal(cq.cpu(), q) and torch.equal(cscale.cpu(), scale)
    assert torch.equal(quant.pack_rows_int8_groups(cq).cpu(),
                       quant.pack_rows_int8_groups(q))
    assert torch.equal(quant.pack_rows_int8_fused(cq, cscale).cpu(),
                       quant.pack_rows_int8_fused(q, scale))


@pytest.mark.cuda
def test_export_round_trip_on_card(cuda):
    frozen = _layer(cuda).freeze(quantize="int8")
    ids, w = _requests(6, cuda)
    blob = serving.export_fn(lambda i, v: frozen(i, v), ids, w)
    got = serving.import_fn(blob)(ids, w)
    with torch.no_grad():
        want = frozen(ids, w)
    for k in want:
        assert torch.equal(got[k], want[k]), k
