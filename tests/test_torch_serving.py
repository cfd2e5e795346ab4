"""The port's serving module (aot_compile, export_fn / import_fn,
make_retrieval_service), freeze and serving_copy against the JAX
package's: the cases of tests/test_serving.py and
tests/test_serving_copy.py, the DLRM's `large_acts` input, and the
serving walkthrough example on the CPU. The CUDA-graph path of
aot_compile is in tests/test_torch_serving_cuda.py.

Tolerances: f32 outputs within 1e-6 relative of the JAX package's (sums
in another order); a round trip through aot_compile or an exported
artifact equal to the eager output; top-k ids equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import B, MULTI_HOT, VOCAB, build_pair, one_device_mesh

from keras_rs_tpu import serving as jax_serving
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import (
    distributed_embedding as jax_de,
)
from keras_rs_tpu.layers.retrieval import retrieval as jax_retrieval
from keras_rs_tpu_torch import serving
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.data.ragged import Ragged
from keras_rs_tpu_torch.examples import serving_deployment
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import distributed_embedding
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)

RTOL = 1e-6
W = np.full((8, 16), 0.05, np.float32)


def _tower(x):
    return torch.tanh(x @ torch.from_numpy(W))


def _jax_tower(x):
    return jnp.tanh(x @ jnp.asarray(W))


def test_aot_compile_fixed_shapes():
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    compiled = serving.aot_compile(_tower, torch.from_numpy(x))
    assert compiled.graph is None  # CPU tensors: checked, then called
    got = compiled(torch.from_numpy(x))
    assert torch.equal(got, _tower(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_tower(x)),
                               rtol=RTOL)


def test_aot_compile_raises_on_mismatch():
    x = torch.ones((4, 8))
    compiled = serving.aot_compile(lambda a, b: {"s": a.sum(1) + b}, x,
                                   torch.zeros(4))
    with pytest.raises(ValueError, match="leaf 0"):
        compiled(torch.ones((5, 8)), torch.zeros(4))
    with pytest.raises(ValueError, match="leaf 1"):
        compiled(x, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="structure"):
        compiled(x, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="densify Ragged"):
        serving.aot_compile(lambda r: r, Ragged.from_lists([[1], [2, 3]]))
    assert torch.equal(compiled(x, torch.zeros(4))["s"], torch.full((4,),
                                                                   8.0))


def test_export_import_roundtrip():
    x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    blob = serving.export_fn(_tower, torch.from_numpy(x))
    assert isinstance(blob, bytes) and len(blob) > 0
    restored = serving.import_fn(blob)
    got = restored(torch.from_numpy(x))
    assert torch.equal(got, _tower(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_tower(x)),
                               rtol=RTOL)
    with pytest.raises(Exception):  # the artifact's shapes are fixed
        restored(torch.ones((5, 8)))


def test_retrieval_service_export_matches_jax():
    rng = np.random.default_rng(2)
    cands = rng.normal(size=(500, 16)).astype(np.float32)
    ids = np.arange(1000, 1500, dtype=np.int64)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    layer = BruteForceRetrieval(torch.from_numpy(cands),
                                torch.from_numpy(ids), k=5)
    service = serving.make_retrieval_service(_tower, layer)
    want_scores, want_ids = service(torch.from_numpy(q))
    j_layer = jax_retrieval.BruteForceRetrieval(
        jnp.asarray(cands), jnp.asarray(ids, jnp.int32), k=5)
    j_scores, j_ids = jax_serving.make_retrieval_service(
        _jax_tower, j_layer)(jnp.asarray(q))
    np.testing.assert_array_equal(want_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(want_scores.numpy(), np.asarray(j_scores),
                               rtol=1e-5)

    blob = serving.export_fn(service, torch.from_numpy(q))
    got_scores, got_ids = serving.import_fn(blob)(torch.from_numpy(q))
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_scores, want_scores)


def _frozen_pair():
    """A JAX and a port DistributedEmbedding with equal tables: one
    mean-combined table read by feature f."""
    def build(cfg):
        t = cfg.TableConfig("t", 128, 16, optimizer="adagrad",
                            combiner="mean", placement="sharded",
                            max_ids_per_partition=64,
                            max_unique_ids_per_partition=64)
        return {"f": cfg.FeatureConfig("f", t, (16, 3), (16, 16))}

    jlayer = jax_de.DistributedEmbedding(
        build(jax_config), key=jax.random.key(0), mesh=one_device_mesh())
    tlayer = distributed_embedding.DistributedEmbedding(
        build(config), generator=torch.Generator().manual_seed(0),
        device="cpu")
    tlayer.set_embedding_tables(jlayer.get_embedding_tables())
    return jlayer, tlayer


def test_frozen_embedding_matches_training_layer():
    jlayer, layer = _frozen_pair()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(16, 3))
    w = rng.random((16, 3)).astype(np.float32)
    with torch.no_grad():
        ref = layer(layer.preprocess({"f": ids}, {"f": w}))["f"]
    frozen = layer.freeze()
    got = frozen({"f": ids}, {"f": w})["f"]
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)
    want = jlayer.freeze()({"f": ids}, {"f": w})["f"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=RTOL)

    ids_t, w_t = torch.from_numpy(ids), torch.from_numpy(w)
    compiled = serving.aot_compile(
        lambda i, v: frozen({"f": i}, {"f": v}), ids_t, w_t)
    assert torch.equal(compiled(ids_t, w_t)["f"], got)
    # Any request batch size: the batch axis is free.
    small = frozen({"f": ids[:5]}, {"f": w[:5]})["f"]
    assert torch.equal(small, got[:5])


def _state_bytes(layer) -> int:
    return sum(t.numel() * t.element_size() for name, t in
               layer.named_buffers() if name.startswith("stack"))


def _storages(module) -> set:
    return {t.untyped_storage().data_ptr() for t in module.buffers()}


def _copy_pair(fcs_of, seed):
    jlayer = jax_de.DistributedEmbedding(
        fcs_of(jax_config), key=jax.random.key(seed),
        mesh=one_device_mesh())
    tlayer = distributed_embedding.DistributedEmbedding(
        fcs_of(config), generator=torch.Generator().manual_seed(seed),
        device="cpu")
    tlayer.set_embedding_tables(jlayer.get_embedding_tables())
    return jlayer, tlayer


def _serve_both(jlayer, tlayer, inputs):
    want = jax.jit(lambda m, p: m(p))(jlayer, jlayer.preprocess(inputs))
    with torch.no_grad():
        got = tlayer(tlayer.preprocess(inputs))
    return want, got


def test_serving_copy_matches_and_drops_slots():
    def fcs_of(cfg):
        t = cfg.TableConfig("t", 256, 16, optimizer="adagrad",
                            combiner="mean", placement="sharded",
                            max_ids_per_partition=64,
                            max_unique_ids_per_partition=64)
        t2 = cfg.TableConfig("t2", 128, 16, optimizer="adam",
                             combiner="sum", placement="sharded",
                             max_ids_per_partition=64,
                             max_unique_ids_per_partition=64)
        return {"f": cfg.FeatureConfig("f", t, (16, 3), (16, 16)),
                "g": cfg.FeatureConfig("g", t2, (16, 2), (16, 16))}

    jlayer, layer = _copy_pair(fcs_of, 0)
    rng = np.random.default_rng(0)
    inputs = {"f": rng.integers(0, 256, size=(16, 3)),
              "g": rng.integers(0, 128, size=(16, 2))}
    _, want = _serve_both(jlayer, layer, inputs)
    copy = layer.serving_copy()
    j_want, got = _serve_both(jlayer.serving_copy(), copy, inputs)
    for k in inputs:
        assert torch.equal(got[k], want[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(j_want[k]),
                                   rtol=RTOL, atol=RTOL)
    # Slot-free: adagrad carries 1 slot, adam 2; the copy keeps the
    # table bytes (plus scalar step counters), in storage of its own.
    assert not [n for n, _ in copy.named_buffers() if "_slot_" in n]
    old_bytes, new_bytes = _state_bytes(layer), _state_bytes(copy)
    table_bytes = sum(v.numel() * v.element_size()
                      for v in layer.get_embedding_tables().values())
    assert new_bytes < old_bytes / 2
    assert new_bytes <= table_bytes * 1.3 + 64
    assert not _storages(copy) & _storages(layer)
    assert [s.name for s in copy.stacks] == [s.name for s in layer.stacks]
    assert all(s.optimizer.name == "sgd" for s in copy.stacks)


def test_serving_copy_preserves_bf16_and_shared_tables():
    """bf16 tables stay bf16. Where the JAX copy hands over the same
    (immutable) array, the port's copies it: a torch buffer is written
    in place by training, so sharing it would tie the two layers."""
    def fcs_of(cfg):
        t = cfg.TableConfig("t", 128, 64, optimizer="adagrad",
                            combiner="mean", placement="sharded",
                            max_ids_per_partition=64,
                            max_unique_ids_per_partition=64,
                            dtype="bfloat16")
        return {"f": cfg.FeatureConfig("f", t, (8, 2), (8, 64)),
                "h": cfg.FeatureConfig("h", t, (8, 1), (8, 64))}

    jlayer, layer = _copy_pair(fcs_of, 1)
    rng = np.random.default_rng(1)
    inputs = {"f": rng.integers(0, 128, size=(8, 2)),
              "h": rng.integers(0, 128, size=(8, 1))}
    _, want = _serve_both(jlayer, layer, inputs)
    copy = layer.serving_copy()
    j_want, got = _serve_both(jlayer.serving_copy(), copy, inputs)
    for k in inputs:
        assert torch.equal(got[k], want[k])
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(j_want[k], np.float32),
                                   rtol=RTOL, atol=RTOL)
    assert copy.stack_state(0)["table"].dtype == torch.bfloat16
    assert torch.equal(copy.stack_state(0)["table"],
                       layer.stack_state(0)["table"])
    assert copy.stack_state(0)["slots"] == {}
    assert not _storages(copy) & _storages(layer)


def test_serving_copy_default_device_tables_shared():
    def fcs_of(cfg):
        t = cfg.TableConfig("t", 64, 8, optimizer="adagrad",
                            combiner="mean", placement="default_device")
        return {"f": cfg.FeatureConfig("f", t, (8, 2), (8, 8))}

    jlayer, layer = _copy_pair(fcs_of, 2)
    copy = layer.serving_copy()
    assert copy.dense_tables["t"] is layer.dense_tables["t"]
    inputs = {"f": np.arange(8 * 2).reshape(8, 2) % 64}
    with torch.no_grad():
        assert torch.equal(copy(inputs)["f"], layer(inputs)["f"])
    np.testing.assert_allclose(copy(inputs)["f"].detach().numpy(),
                               np.asarray(jlayer(inputs)["f"]), rtol=RTOL)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_dlrm_large_acts_match_jax(quantize):
    """A FrozenEmbedding of the large features feeds the dense stack
    through "large_acts", in both packages (f32 dense stack)."""
    jmodel, tmodel = build_pair(seed=2, compute_dtype=None,
                                dense_output_dtype="float32")
    raw = synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                      multi_hot_sizes=MULTI_HOT, seed=5)
    large = {f"cat_{i}": raw[f"cat_{i}"] for i in tmodel.large_idx}
    rest = {k: v for k, v in raw.items() if k not in large}
    jfrozen = jmodel.embedding_layer.freeze(quantize=quantize)
    tfrozen = tmodel.embedding_layer.freeze(quantize=quantize)
    j_logits = jmodel({**{k: jnp.asarray(v) for k, v in rest.items()},
                       "large_acts": jfrozen(large)})
    batch = {k: torch.from_numpy(v) for k, v in rest.items()}
    with torch.no_grad():
        t_logits = tmodel({**batch, "large_acts": tfrozen(large)})
        scored = tmodel(tmodel.preprocess(raw))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    if quantize is None:  # the same tables through the stacked lookup
        np.testing.assert_allclose(t_logits.numpy(), scored.numpy(),
                                   rtol=1e-5, atol=1e-5)

    # Captured and exported with the batch as tensors.
    def serve(b, large_ids):
        return tmodel({**b, "large_acts": tfrozen(large_ids)})

    large_t = {k: torch.from_numpy(v) for k, v in large.items()}
    compiled = serving.aot_compile(serve, batch, large_t)
    assert torch.equal(compiled(batch, large_t), t_logits)
    blob = serving.export_fn(serve, batch, large_t)
    assert torch.equal(serving.import_fn(blob)(batch, large_t), t_logits)


def test_serving_deployment_example_runs_on_cpu():
    out = serving_deployment.main(device="cpu")
    assert out["frozen_aot"] < 1e-4 and out["copy"] < 1e-4
    # int8 error stays within the int8 bound's scale for these scores.
    assert out["int8"] < 0.05
    assert out["int8_bytes"] < out["f32_bytes"] / 3
    assert out["copy_state_bytes"] < out["train_state_bytes"] / 1.9
