"""The public arguments and methods of the JAX package that the port
added last (ROADMAP A2), each held to the JAX call on the same inputs:
`Dense(use_bias=, kernel_initializer=, bias_initializer=, name=)`,
`MLP(activation=, final_activation=, name=)`, `EmbedReduce.from_config`,
`preprocess_stack(..., allow_drop=False)`, `combine_cotangents`,
`global_batch_from_host_shards(..., axis_name=)`,
`parse_file_batched(..., copy_bytes=True)`, `GRU(name=)` and
`Embedding(name=)`.

Bounds: f32 layer outputs within 1e-6 (the same formulas; matmul order
differs by an ulp or two); initializers, configs, cotangent layouts,
file columns and names equal exactly.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.data import native_io as jax_native_io
from keras_rs_tpu.layers import attention as jax_attention
from keras_rs_tpu.layers import dense as jax_dense
from keras_rs_tpu.layers import recurrent as jax_recurrent
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import embed_reduce as jax_embed_reduce
from keras_rs_tpu.layers.embedding import lookup as jax_lookup
from keras_rs_tpu.layers.embedding import preprocessing as jax_pre
from keras_rs_tpu.layers.embedding import stacking as jax_stacking
from keras_rs_tpu.parallel import mesh as jax_mesh
from keras_rs_tpu.parallel import multihost as jax_multihost
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.data import criteo, native_io
from keras_rs_tpu_torch.layers import attention, dense, recurrent
from keras_rs_tpu_torch.layers.embedding import config, embed_reduce, lookup
from keras_rs_tpu_torch.layers.embedding import native, preprocessing
from keras_rs_tpu_torch.layers.embedding import stacking
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.parallel import multihost

B = 16
IN, UNITS = 12, (16, 8, 4)


def _x(seed=0, rows=B, cols=IN):
    return np.random.default_rng(seed).normal(
        size=(rows, cols)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_dense_without_bias_matches_jax():
    j = jax_dense.Dense(IN, 8, key=jax.random.key(1), use_bias=False,
                        activation=jax.nn.relu, name="proj")
    t = dense.Dense(IN, 8, use_bias=False, activation=torch.relu,
                    device="cpu", name="proj")
    assert t.bias is None and [n for n, _ in t.named_parameters()] == [
        "kernel"]
    # The JAX layer's bias is None: convert carries it as absent.
    convert.load_params(t, {"kernel": np.asarray(j.kernel), "bias": j.bias})
    _close(t(torch.from_numpy(_x())), j(jnp.asarray(_x())))
    assert t.name == j.name == "proj"
    assert dense.Dense(IN, 8, device="cpu").name == jax_dense.Dense(
        IN, 8, key=jax.random.key(0)).name == "dense"
    with pytest.raises(ValueError, match="missing"):
        convert.load_params(dense.Dense(IN, 8, device="cpu"),
                            {"kernel": np.asarray(j.kernel), "bias": None})


@pytest.mark.parametrize("kernel, bias", [("zeros", "ones"),
                                          ("ones", "zeros")])
def test_dense_initializers_bit_for_bit(kernel, bias):
    j = jax_dense.Dense(IN, 8, key=jax.random.key(0),
                        kernel_initializer=kernel, bias_initializer=bias)
    t = dense.Dense(IN, 8, kernel_initializer=kernel, bias_initializer=bias,
                    device="cpu")
    assert np.array_equal(t.kernel.detach().numpy(), np.asarray(j.kernel))
    assert np.array_equal(t.bias.detach().numpy(), np.asarray(j.bias))


def test_mlp_activations_match_jax():
    j = jax_dense.MLP(IN, UNITS, key=jax.random.key(2),
                      activation=jax.nn.tanh,
                      final_activation=jax.nn.sigmoid, name="tower")
    t = dense.MLP(IN, UNITS, activation=torch.tanh,
                  final_activation=torch.sigmoid, device="cpu",
                  name="tower")
    torch_parity.load_from_jax(t, j)
    _close(t(torch.from_numpy(_x(1))), j(jnp.asarray(_x(1))))
    assert t.name == j.name == "tower"
    # The defaults: ReLU between layers, none after the last.
    jd = jax_dense.MLP(IN, UNITS, key=jax.random.key(3))
    td = torch_parity.load_from_jax(dense.MLP(IN, UNITS, device="cpu"), jd)
    out = td(torch.from_numpy(_x(2)))
    _close(out, jd(jnp.asarray(_x(2))))
    assert (out < 0).any() and td.name == jd.name == "mlp"


def test_bias_less_dense_stack_carries_from_jax():
    """A stack of bias-less JAX Dense layers into the port's through
    `convert.load_params`, None biases and all."""
    keys = jax.random.split(jax.random.key(4), len(UNITS))
    dims = (IN,) + UNITS
    j_layers = [jax_dense.Dense(a, b, key=k, use_bias=False,
                                activation=jax.nn.relu)
                for a, b, k in zip(dims, dims[1:], keys)]
    t = torch.nn.Sequential(*(dense.Dense(a, b, use_bias=False,
                                          activation=torch.relu,
                                          device="cpu")
                              for a, b in zip(dims, dims[1:])))
    params = {}
    for i, layer in enumerate(j_layers):
        params[f"{i}.kernel"] = np.asarray(layer.kernel)
        params[f"{i}.bias"] = layer.bias
    convert.load_params(t, params)
    x = jnp.asarray(_x(3))
    for layer in j_layers:
        x = layer(x)
    _close(t(torch.from_numpy(_x(3))), x)


def test_embed_reduce_from_config_round_trips():
    j = jax_embed_reduce.EmbedReduce(100, 8, key=jax.random.key(0),
                                     combiner="sqrtn", name="items")
    cfg = j.get_config()
    t = embed_reduce.EmbedReduce.from_config(dict(cfg, device="cpu"))
    assert t.get_config() == cfg
    again = embed_reduce.EmbedReduce.from_config(
        dict(t.get_config(), device="cpu"))
    assert again.get_config() == cfg
    assert jax_embed_reduce.EmbedReduce.from_config(
        t.get_config()).get_config() == cfg
    assert tuple(t.embeddings.shape) == (100, 8)


def _stack(cfg_mod, stacking_mod, C, U, dims=(8, 8)):
    fcs = []
    for i, (vocab, valence, dim) in enumerate(zip((300, 120), (3, 2),
                                                   dims)):
        table = cfg_mod.TableConfig(
            name=f"t{i}", vocabulary_size=vocab, embedding_dim=dim,
            optimizer="sgd", combiner="mean", placement="sharded",
            max_ids_per_partition=C, max_unique_ids_per_partition=U)
        fcs.append(cfg_mod.FeatureConfig(f"f{i}", table, (B, valence),
                                         (B, dim)))
    (stack,) = stacking_mod.build_stacks(fcs, 1, stacking=[["t0", "t1"]])
    return stack


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    return {"f0": rng.integers(0, 300, size=(B, 3)),
            "f1": rng.integers(0, 120, size=(B, 2))}


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_allow_drop_false_raises_on_both_routes(backend):
    if backend == "native" and not native.available():
        pytest.fail("the C++ COO engine does not build (g++)")
    ours = _stack(config, stacking, C=20, U=16)
    ref = _stack(jax_config, jax_stacking, C=20, U=16)
    with pytest.warns(UserWarning) as warned:
        preprocessing.preprocess_stack(ours, _ids(), backend=backend)
    with pytest.raises(ValueError) as raised:
        preprocessing.preprocess_stack(ours, _ids(), allow_drop=False,
                                       backend=backend)
    assert str(raised.value) == str(warned[0].message)
    assert "over bucket capacity 20" in str(raised.value)
    jax_backend = "native" if backend == "native" else "numpy"
    with pytest.raises(ValueError, match="max_ids_per_partition"):
        jax_pre.preprocess_stack(ref, _ids(), allow_drop=False,
                                 backend=jax_backend)
    # Within the capacities nothing is raised, and the arrays are the
    # JAX package's.
    fits = dict(C=B * 5, U=B * 5)
    coo, stats = preprocessing.preprocess_stack(
        _stack(config, stacking, **fits), _ids(), allow_drop=False,
        backend=backend)
    want, want_stats = jax_pre.preprocess_stack(
        _stack(jax_config, jax_stacking, **fits), _ids(), allow_drop=False,
        backend=jax_backend)
    assert stats.dropped_ids == want_stats.dropped_ids == 0
    for k, v in want.arrays().items():
        assert np.array_equal(coo.arrays()[k], np.asarray(v)), k


def test_combine_cotangents_matches_jax():
    ours = _stack(config, stacking, C=B * 5, U=B * 5, dims=(16, 8))
    ref = _stack(jax_config, jax_stacking, C=B * 5, U=B * 5, dims=(16, 8))
    rng = np.random.default_rng(5)
    d = {"f0": rng.normal(size=(B, 16)).astype(np.float32),
         "f1": rng.normal(size=(B, 8)).astype(np.float32)}
    got = lookup.combine_cotangents(
        ours, {k: torch.from_numpy(v) for k, v in d.items()})
    want = np.asarray(jax_lookup.combine_cotangents(
        ref, {k: jnp.asarray(v) for k, v in d.items()}))
    assert got.shape == want.shape == (B * 2, 16)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, lookup.merge_cotangents(
        ours, {k: torch.from_numpy(v) for k, v in d.items()},
        torch.device("cpu")))
    with pytest.raises(ValueError, match="at least one"):
        lookup.combine_cotangents(ours, {"f0": None, "f1": None})


def test_global_batch_from_host_shards_takes_axis_name():
    batch = {"dense": _x(4), "cat_0": np.arange(B)}
    mesh = mesh_lib.create_mesh("cpu")
    jmesh = jax_mesh.create_mesh(jax.devices()[:1])
    got = multihost.global_batch_from_host_shards(mesh, batch,
                                                  axis_name="data")
    want = jax_multihost.global_batch_from_host_shards(jmesh, batch,
                                                       axis_name="data")
    for k in batch:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    with pytest.raises(ValueError, match="Unknown mesh axes"):
        multihost.global_batch_from_host_shards(mesh, batch,
                                                axis_name="model")
    with pytest.raises(Exception):
        jax_multihost.global_batch_from_host_shards(jmesh, batch,
                                                    axis_name="model")


def test_copy_bytes_columns_outlive_the_next_parse(tmp_path):
    if not native_io.available() or not jax_native_io.available():
        pytest.fail("the native TFRecord reader does not build (g++)")
    a, b = criteo.write_batched_criteo_files(
        str(tmp_path), num_files=2, protos_per_file=3, file_batch_size=20,
        vocab_sizes=[1000, 50], multi_hot_sizes=[2, 1], seed=3)
    keys = criteo.CriteoDataset(
        None, global_batch_size=20, vocab_sizes=[1000, 50],
        multi_hot_sizes=[2, 1], file_batch_size=20)._file_keys()
    n, copied = native_io.parse_file_batched(a, keys, copy_bytes=True)
    _, views = native_io.parse_file_batched(a, keys)
    kept = {k: np.array(arr) for k, (_, arr) in views.items()}
    n_ref, want = jax_native_io.parse_file_batched(a, keys, copy_bytes=True)
    assert n == n_ref == 3
    bytes_keys = [k for k, (kind, _) in copied.items() if kind == 0]
    assert bytes_keys
    native_io.parse_file_batched(b, keys)  # reuses the pooled buffer
    # The views now show the second file; the copies still the first.
    assert any(not np.array_equal(views[k][1], kept[k]) for k in bytes_keys)
    for k, (kind, arr) in copied.items():
        assert kind == want[k][0]
        assert np.array_equal(arr, kept[k]), k
        assert np.array_equal(arr, np.asarray(want[k][1])), k


def test_gru_and_embedding_take_name():
    g = recurrent.GRU(4, 8, device="cpu", name="session")
    jg = jax_recurrent.GRU(4, 8, key=jax.random.key(0), name="session")
    assert g.name == jg.name == "session"
    assert recurrent.GRU(4, 8, device="cpu").name == jax_recurrent.GRU(
        4, 8, key=jax.random.key(0)).name == "gru"
    e = attention.Embedding(10, 4, device="cpu", name="items")
    je = jax_attention.Embedding(10, 4, key=jax.random.key(0), name="items")
    assert e.name == je.name == "items"
    assert attention.Embedding(10, 4, device="cpu").name == (
        jax_attention.Embedding(10, 4, key=jax.random.key(0)).name)
    for ours, ref in ((recurrent.GRU, jax_recurrent.GRU),
                      (attention.Embedding, jax_attention.Embedding)):
        assert inspect.signature(ours).parameters["name"].default is None
        assert inspect.signature(ref).parameters["name"].default is None
