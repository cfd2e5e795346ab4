"""The port's int8 serving tables (ops/quant.py, QuantizedEmbedReduce,
DistributedEmbedding.freeze) against the JAX package's: the cases of
tests/test_quantized_serving.py but the config round trips (A13
serialization), each on the same seeded numpy inputs in both packages.

Tolerances: q, scale and the packed and fused words bit-exact (0);
activations of the port against the JAX package's within 1e-6 relative
(f32 sums in another order); the port's layouts against each other
bit-exact, as in the JAX tests.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity import one_device_mesh

from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import (
    distributed_embedding as jax_de,
)
from keras_rs_tpu.layers.embedding import embed_reduce as jax_er
from keras_rs_tpu.ops import quant as jax_quant
from keras_rs_tpu_torch import convert, serving
from keras_rs_tpu_torch.convert import as_tensor
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import distributed_embedding
from keras_rs_tpu_torch.layers.embedding.embed_reduce import (
    EmbedReduce,
    QuantizedEmbedReduce,
)
from keras_rs_tpu_torch.ops import quant

RTOL = 1e-6


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def _assert_bits(got: torch.Tensor, want) -> None:
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _table(rng, rows, dim=32):
    """Heavy-tailed row magnitudes, a zero row, a one-spike row."""
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    x *= rng.lognormal(sigma=2.0, size=(rows, 1)).astype(np.float32)
    x[7] = 0.0
    x[9] = 0.0
    x[9, 3] = 1e-6
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_exact_and_error_bound(dtype):
    rng = np.random.default_rng(0)
    x = _table(rng, 64, 32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    q, scale = quant.quantize_rows_int8(as_tensor(x))
    jq, js = jax_quant.quantize_rows_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(scale.shape) == (64, 1)
    _assert_bits(q, jq)
    _assert_bits(scale, js)
    deq = quant.dequantize_rows(q, scale).numpy().astype(np.float64)
    xf = np.asarray(x, np.float64)
    absmax = np.abs(xf).max(axis=1, keepdims=True)
    bound = absmax / 254 * (1 + 1e-5) + 1e-12
    assert (np.abs(deq - xf) <= bound).all()
    np.testing.assert_array_equal(deq[7], 0.0)


def test_quantize_in_chunks_equals_whole_table():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_table(rng, 101, 16))
    q = torch.empty((101, 16), dtype=torch.int8)
    scale = torch.empty((101, 1))
    quant.quantize_rows_int8_into(lambda lo, hi: x[lo:hi], 101, q, scale,
                                  chunk_rows=13)
    wq, ws = quant.quantize_rows_int8(x)
    assert torch.equal(q, wq) and torch.equal(scale, ws)


@pytest.mark.parametrize("rows", [101, 64])
def test_packed_and_fused_words_bit_exact(rows):
    rng = np.random.default_rng(2)
    q = rng.integers(-127, 128, size=(rows, 128), dtype=np.int8)
    scale = ((rng.random(rows, dtype=np.float32) + 0.5) / 127.0)
    packed = quant.pack_rows_int8_groups(torch.from_numpy(q))
    assert packed.dtype == torch.int32
    _assert_bits(packed, jax_quant.pack_rows_int8_groups(jnp.asarray(q)))
    fused = quant.pack_rows_int8_fused(torch.from_numpy(q),
                                       torch.from_numpy(scale))
    assert tuple(fused.shape) == ((rows + 7) // 8, 384)
    _assert_bits(fused, jax_quant.pack_rows_int8_fused(jnp.asarray(q),
                                                       jnp.asarray(scale)))
    assert torch.equal(quant.unpack_rows_int8_groups(packed, rows),
                       torch.from_numpy(q))
    q2, s2 = quant.unpack_rows_int8_fused(fused, rows)
    assert torch.equal(q2, torch.from_numpy(q))
    assert torch.equal(s2, torch.from_numpy(scale))


def test_fused_take_bit_identical_to_rows():
    rng = np.random.default_rng(12)
    R, N = 1000, 333
    q = rng.integers(-127, 128, size=(R, 128), dtype=np.int8)
    scale = (rng.random(R, dtype=np.float32) + 0.5) / 127.0
    ids = rng.integers(0, R, size=(N,))
    want = q[ids].astype(np.float32) * scale[ids][:, None]
    packed = quant.pack_rows_int8_fused(torch.from_numpy(q),
                                        torch.from_numpy(scale))
    got = quant.take_rows_int8_fused(packed, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    got2 = quant.take_rows_int8_fused(packed,
                                      torch.from_numpy(ids.reshape(3, 111)))
    assert tuple(got2.shape) == (3, 111, 128)
    np.testing.assert_array_equal(got2.reshape(N, 128).numpy(), want)


@pytest.mark.parametrize("layout", ["rows", "packed", "fused"])
def test_out_of_range_ids_follow_each_layout(layout):
    """"rows" gives NaN outside [-R, R) and wraps -1; "packed" and
    "fused" clip the group index (and the packed scale index), as the
    JAX package's layouts do: outputs equal JAX's, NaN for NaN."""
    rng = np.random.default_rng(3)
    R = 101
    table = _table(rng, R, 128)
    ids = np.array([[0, 5, -1], [R, -R - 1, -R], [R - 1, 3 * R, -7]])
    want = jax_er.QuantizedEmbedReduce.from_table(
        table, combiner="sum", layout=layout)._lookup(jnp.asarray(ids))
    got = QuantizedEmbedReduce.from_table(
        torch.from_numpy(table), combiner="sum", layout=layout
    )._lookup(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()).any() == (layout == "rows")


def test_quantized_embed_reduce_matches_jax_and_f32():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(100, 16)).astype(np.float32)
    ids2d = rng.integers(0, 100, size=(8, 5))
    w2d = rng.random((8, 5)).astype(np.float32)
    ids1d = rng.integers(0, 100, size=(8,))
    for combiner in ("mean", "sum", "sqrtn"):
        er = EmbedReduce(100, 16, table=torch.from_numpy(table),
                         combiner=combiner)
        qer = er.quantize_int8()
        assert isinstance(qer, QuantizedEmbedReduce)
        jqer = jax_er.EmbedReduce(100, 16, table=table,
                                  combiner=combiner).quantize_int8()
        _assert_bits(qer.q, jqer.q)
        _assert_bits(qer.scale, jqer.scale)
        for args in [(ids2d, w2d), (ids2d, None), (ids1d, None)]:
            t_args = [None if a is None else torch.from_numpy(a)
                      for a in args]
            got = qer(*t_args).numpy()
            np.testing.assert_allclose(got, np.asarray(jqer(*args)),
                                       rtol=RTOL, atol=RTOL)
            want = er(*t_args).detach().numpy()
            np.testing.assert_allclose(got, want,
                                       atol=np.abs(table).max() / 100,
                                       rtol=0.02)


def test_quantized_reducer_buffers_and_memory():
    table = np.random.default_rng(2).normal(size=(256, 32)).astype(
        np.float32)
    qer = QuantizedEmbedReduce.from_table(torch.from_numpy(table),
                                          combiner="mean")
    # 4x smaller row payload (+ one f32 scale per row), held as buffers.
    assert qer.q.nbytes == table.nbytes // 4
    assert qer.scale.nbytes == 256 * 4
    assert set(qer.state_dict()) == {"q", "scale"}
    assert not list(qer.parameters())
    moved = qer.to(torch.float64)  # buffers keep their integer type
    assert moved.q.dtype == torch.int8
    out = qer(torch.tensor([[1, 2, 3], [4, 5, 6]]))
    assert tuple(out.shape) == (2, 32) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("rows", [101, 64])
def test_packed_layout_bit_identical_to_rows(rows):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(rows, 16)).astype(np.float32))
    ids2d = torch.from_numpy(rng.integers(0, rows, size=(8, 5)))
    w2d = torch.from_numpy(rng.random((8, 5)).astype(np.float32))
    ids1d = torch.from_numpy(rng.integers(0, rows, size=(32,)))
    for combiner in ("mean", "sum", "sqrtn"):
        er = EmbedReduce(rows, 16, table=table, combiner=combiner)
        q_rows = er.quantize_int8()
        q_packed = er.quantize_int8(layout="packed")
        assert q_packed.layout == "packed"
        assert q_packed.qp.dtype == torch.int32
        assert tuple(q_packed.qp.shape) == ((rows + 3) // 4, 16)
        for args in [(ids2d, w2d), (ids2d, None), (ids1d, None)]:
            assert torch.equal(q_packed(*args), q_rows(*args))
        assert torch.equal(q_packed.embeddings, q_rows.embeddings)


def test_packed_layout_state_dict_transplant():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(37, 8)).astype(np.float32))
    qer = QuantizedEmbedReduce.from_table(table, layout="packed")
    other = QuantizedEmbedReduce.from_table(torch.zeros(37, 8),
                                            layout="packed")
    other.load_state_dict(qer.state_dict())
    ids = torch.from_numpy(rng.integers(0, 37, size=(16,)))
    assert torch.equal(other(ids), qer(ids))


def test_prepacked_jax_words_serve_as_from_table():
    """`_from_packed` / `_from_fused` wrap words packed elsewhere (here
    the JAX package's) without repacking: lookups equal the port's own
    packing of the same table, bit for bit."""
    rng = np.random.default_rng(6)
    R = 45
    table = _table(rng, R, 128)
    jq, js = jax_quant.quantize_rows_int8(jnp.asarray(table))
    ids = torch.from_numpy(rng.integers(0, R, size=(6, 4)))
    packed = QuantizedEmbedReduce._from_packed(
        as_tensor(jax_quant.pack_rows_int8_groups(jq)),
        as_tensor(np.asarray(js).reshape(-1)), R, combiner="sqrtn")
    fused = QuantizedEmbedReduce._from_fused(
        as_tensor(jax_quant.pack_rows_int8_fused(jq, js.reshape(-1))), R,
        combiner="sqrtn")
    for wrapped in (packed, fused):
        own = QuantizedEmbedReduce.from_table(
            torch.from_numpy(table), combiner="sqrtn",
            layout=wrapped.layout)
        assert torch.equal(wrapped(ids), own(ids))
        assert torch.equal(wrapped.embeddings, own.embeddings)


def test_fused_requires_dim_128_and_known_layout():
    q = torch.zeros((8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="dim == 128"):
        QuantizedEmbedReduce(q, torch.ones(8, 1), layout="fused")
    with pytest.raises(ValueError, match="layout"):
        QuantizedEmbedReduce(q, torch.ones(8, 1), layout="int4")


def _layer_pair(feature_specs, seed=0, **table_kw):
    """JAX and port DistributedEmbedding layers with equal tables.
    feature_specs: [(feature, table_name, vocab, dim, combiner, shape)]."""
    def build(cfg):
        tables = {}
        feats = {}
        for name, tname, vocab, dim, combiner, shape in feature_specs:
            if tname not in tables:
                tables[tname] = cfg.TableConfig(
                    name=tname, vocabulary_size=vocab, embedding_dim=dim,
                    combiner=combiner, **table_kw)
            feats[name] = cfg.FeatureConfig(
                name=name, table=tables[tname], input_shape=shape,
                output_shape=(shape[0], dim))
        return feats

    jlayer = jax_de.DistributedEmbedding(
        build(jax_config), key=jax.random.key(seed), mesh=one_device_mesh())
    tlayer = distributed_embedding.DistributedEmbedding(
        build(config), generator=torch.Generator().manual_seed(seed),
        device="cpu")
    tlayer.set_embedding_tables(jlayer.get_embedding_tables())
    return jlayer, tlayer


SHARDED = dict(placement="sharded", optimizer="adagrad",
               max_ids_per_partition=64, max_unique_ids_per_partition=64)
FEATURES = [
    ("f", "t", 128, 16, "mean", (16, 3)),
    # Shared table: g and h must use the same quantized tensors.
    ("g", "t2", 64, 128, "sum", (16, 2)),
    ("h", "t2", 64, 128, "sum", (16, 2)),
]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f": rng.integers(0, 128, size=(16, 3)),
        "g": rng.integers(0, 64, size=(16, 2)),
        "h": rng.integers(0, 64, size=(16, 2)),
    }


def _jax_arrays(frozen) -> dict:
    """{feature: {field: numpy}} of a JAX FrozenEmbedding."""
    out = {}
    for name, er in frozen._reducers.items():
        fields = ("q", "scale", "qp") if isinstance(
            er, jax_er.QuantizedEmbedReduce) else ("embeddings",)
        out[name] = {f: np.asarray(getattr(er, f)) for f in fields
                     if hasattr(er, f)}
    return out


@pytest.mark.parametrize("quantize",
                         [None, "int8", "int8_packed", "int8_fused"])
@pytest.mark.parametrize("placement", ["sharded", "default_device"])
def test_freeze_matches_jax_frozen_embedding(quantize, placement):
    kw = dict(SHARDED, placement=placement)
    jlayer, tlayer = _layer_pair(FEATURES, **kw)
    jfrozen = jlayer.freeze(quantize=quantize)
    tfrozen = tlayer.freeze(quantize=quantize)
    # The arrays bit for bit (q, scale, the packed and fused words).
    for name, fields in _jax_arrays(jfrozen).items():
        module = tfrozen._reducers[name]
        for field, want in fields.items():
            got = getattr(module, field).detach()
            _assert_bits(got, want)
    inputs = _inputs()
    want = jfrozen(inputs)
    got = tfrozen(inputs)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL,
                                   atol=RTOL)
    # Shared-table features hold the same module and tensors.
    assert tfrozen._reducers["g"] is tfrozen._reducers["h"]
    layouts = {"int8": "rows", "int8_packed": "packed",
               "int8_fused": "fused"}
    if quantize is not None:
        assert tfrozen._reducers["g"].layout == layouts[quantize]
        # dim 16: the fused freeze keeps the rows layout, as in JAX.
        assert tfrozen._reducers["f"].layout == (
            "rows" if quantize == "int8_fused" else layouts[quantize])
    tables = tfrozen.tables
    assert tuple(tables["t"].shape) == (128, 16)
    assert tuple(tables["t2"].shape) == (64, 128)


def test_freeze_int8_from_bf16_capacity_stack_bit_exact():
    """Capacity mode (bf16 tables, row-wise Adagrad): the port quantizes
    chunk by chunk from the stacked bf16 rows, JAX from its exported
    tables; q and scale agree bit for bit."""
    specs = [("a", "ta", 300, 128, "sum", (16, 3)),
             ("b", "tb", 200, 128, "sum", (16, 1))]
    jlayer, tlayer = _layer_pair(
        specs, dtype="bfloat16", placement="sharded",
        optimizer="rowwise_adagrad", max_ids_per_partition=64,
        max_unique_ids_per_partition=64)
    assert tlayer.stack_state(0)["table"].dtype == torch.bfloat16
    jfrozen = jlayer.freeze(quantize="int8")
    tfrozen = tlayer.freeze(quantize="int8")
    for name, fields in _jax_arrays(jfrozen).items():
        for field, want in fields.items():
            _assert_bits(getattr(tfrozen._reducers[name], field), want)
    rng = np.random.default_rng(9)
    inputs = {"a": rng.integers(0, 300, (16, 3)),
              "b": rng.integers(0, 200, (16, 1))}
    want, got = jfrozen(inputs), tfrozen(inputs)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=RTOL)


def test_freeze_int8_matches_f32_freeze_within_bound():
    _, tlayer = _layer_pair(FEATURES, **SHARDED)
    inputs = _inputs(1)
    want = tlayer.freeze()(inputs)
    got = tlayer.freeze(quantize="int8")(inputs)
    for k in inputs:
        w = want[k].detach().numpy()
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=np.abs(w).max() * 0.02 + 1e-4)


def test_int8_layouts_bit_identical_after_freeze():
    _, tlayer = _layer_pair(FEATURES, **SHARDED)
    inputs = _inputs(2)
    out8 = tlayer.freeze(quantize="int8")(inputs)
    for quantize in ("int8_packed", "int8_fused"):
        frozen = tlayer.freeze(quantize=quantize)
        got = frozen(inputs)
        for k in out8:
            assert torch.equal(got[k], out8[k]), (quantize, k)
        assert frozen._reducers["g"].qp is frozen._reducers["h"].qp


def test_load_serving_arrays_carries_jax_frozen_embedding():
    jlayer, tlayer = _layer_pair(FEATURES, **SHARDED)
    for quantize in ("int8", "int8_packed", "int8_fused"):
        jfrozen = jlayer.freeze(quantize=quantize)
        # A port frozen layer of other tables, overwritten by JAX's arrays.
        other = distributed_embedding.DistributedEmbedding(
            {fc.name: fc for fc in tlayer._feature_leaves},
            generator=torch.Generator().manual_seed(7), device="cpu",
        ).freeze(quantize=quantize)
        convert.load_serving_arrays(other, _jax_arrays(jfrozen))
        inputs = _inputs(3)
        want, got = jfrozen(inputs), other(inputs)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=RTOL)
    with pytest.raises(ValueError, match="holds no tensor"):
        convert.load_serving_arrays(other._reducers["f"],
                                    {"embeddings": np.zeros((128, 16))})


def _artifact_tensor_bytes(blob: bytes) -> int:
    import io

    program = torch.export.load(io.BytesIO(blob))
    tensors = [*program.state_dict.values(), *program.constants.values()]
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def test_freeze_int8_export_roundtrip_and_size():
    """The tables are baked into the artifact: the int8 one carries 0.28
    of the f32 one's table bytes (1 byte per element and a 4-byte scale
    per 32-wide row). The rest of an artifact is the saved program, ~40
    kB here whatever the table, so whole-artifact ratios say little at
    this size."""
    specs = [("f", "t", 512, 32, "mean", (8, 4))]
    _, tlayer = _layer_pair(specs, **dict(SHARDED, optimizer="sgd"))
    frozen = tlayer.freeze()
    quantized = tlayer.freeze(quantize="int8")
    ids = torch.from_numpy(
        np.random.default_rng(4).integers(0, 512, size=(8, 4)))
    blob_f32 = serving.export_fn(lambda i: frozen({"f": i})["f"], ids)
    blob_int8 = serving.export_fn(lambda i: quantized({"f": i})["f"], ids)
    assert _artifact_tensor_bytes(blob_f32) == 512 * 32 * 4
    assert _artifact_tensor_bytes(blob_int8) == 512 * 32 + 512 * 4
    assert len(blob_int8) < len(blob_f32) - 0.5 * 512 * 32 * 4
    served = serving.import_fn(blob_int8)
    np.testing.assert_allclose(served(ids).numpy(),
                               quantized({"f": ids})["f"].numpy(),
                               rtol=1e-6)


def test_freeze_rejects_unknown_quantize():
    specs = [("f", "t", 128, 8, "mean", (8, 2))]
    _, tlayer = _layer_pair(specs, **dict(SHARDED, optimizer="sgd"))
    with pytest.raises(ValueError, match="int8"):
        tlayer.freeze(quantize="int4")
