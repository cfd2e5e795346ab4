"""Stack layout decisions and table initialization of the port
(layers/embedding/stacking.py, lookup.init_stack_state) against the JAX
package, and the bf16 array conversion of convert.py.

Integer layout and dtype decisions are compared exactly.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import stacking as jax_stacking
from keras_rs_tpu_torch.convert import as_tensor
from keras_rs_tpu_torch.layers.embedding import config, stacking
from keras_rs_tpu_torch.layers.embedding.lookup import init_stack_state

B = 16
OPTIMIZERS = ["sgd", "adagrad", "rowwise_adagrad", "adam", "ftrl"]


def _fcs(cfg_mod, dtype, optimizer, dim, vocab=100):
    t = cfg_mod.TableConfig(
        name="t", vocabulary_size=vocab, embedding_dim=dim,
        optimizer=optimizer, combiner="sum", placement="sharded",
        dtype=dtype, max_ids_per_partition=2 * B,
        max_unique_ids_per_partition=2 * B,
    )
    return [cfg_mod.FeatureConfig(name="f", table=t, input_shape=(B, 2),
                                  output_shape=(B, dim))]


@pytest.mark.parametrize(
    "dtype, optimizer, dim",
    list(itertools.product(["float32", "bfloat16"], OPTIMIZERS,
                           [16, 64, 128, 256])),
)
def test_packed_rule_matches_jax(dtype, optimizer, dim):
    """Packed exactly where the JAX package packs: f32, slots, none of
    them row-wise, dim % 128 == 0 and (1 + slots) * dim <= 512."""
    (ours,) = stacking.build_stacks(_fcs(config, dtype, optimizer, dim), 1)
    (ref,) = jax_stacking.build_stacks(
        _fcs(jax_config, dtype, optimizer, dim), 1)
    assert ours.packed_state == ref.packed_state
    assert ours.state_stride == ref.state_stride
    assert ours.storage_dtype == {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}[dtype]
    if not ref.bitpacked_state:  # the port keeps plain bf16 rows
        assert ours.rows_per_shard == ref.rows_per_shard
    else:
        assert ours.rows_per_shard == 100 + 1


def _stack(vocab, dim, dtype="float32", optimizer="sgd"):
    fcs = _fcs(config, dtype, optimizer, dim, vocab)
    (s,) = stacking.build_stacks(fcs, 1)
    return s, {"t": fcs[0].table}


def test_chunked_init_is_the_same_whatever_the_chunk_size():
    """Three draw blocks and a ragged end: every chunk size (whole
    blocks, a size that is not a multiple of them, one chunk) gives the
    same rows from the same generator."""
    vocab = 2 * stacking.INIT_DRAW_ROWS + 1234
    stack, cfgs = _stack(vocab, 3)
    outs = [
        stacking.init_stack_table(
            stack, cfgs, torch.Generator().manual_seed(5), "cpu",
            chunk_rows=c,
        )
        for c in (stacking.INIT_DRAW_ROWS, stacking.INIT_DRAW_ROWS + 7,
                  2 * stacking.INIT_DRAW_ROWS, vocab + 10)
    ]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    # Real rows are drawn (truncated normal, fan_out = 3), the dim padding
    # (3 -> 8) and the sink row are zero.
    real = outs[0][:vocab, :3]
    assert real.ne(0).all()
    np.testing.assert_allclose(float(real.std()), 3 ** -0.5, rtol=0.02)
    assert outs[0][:, 3:].eq(0).all() and outs[0][stack.sink_slot].eq(0).all()
    other = stacking.init_stack_table(
        stack, cfgs, torch.Generator().manual_seed(6), "cpu")
    assert not torch.equal(other, outs[0])


def test_init_draws_in_the_storage_dtype_with_the_tables_fans():
    """bf16 stacks are allocated in bf16 (rows rounded from the f32 draw);
    a fan_in initializer is scaled by the whole vocabulary, not a chunk."""
    stack, cfgs = _stack(1000, 8, dtype="bfloat16")
    cfgs["t"].initializer = "glorot_uniform"  # fan_avg over (1000, 8)
    out = stacking.init_stack_table(
        stack, cfgs, torch.Generator().manual_seed(0), "cpu", chunk_rows=1)
    assert out.dtype == torch.bfloat16 and out.shape == (1001, 8)
    limit = (6.0 / (1000 + 8)) ** 0.5
    assert float(out.float().abs().max()) <= limit * (1 + 2**-8)
    assert float(out.float().abs().max()) > 0.9 * limit


@pytest.mark.parametrize(
    "dtype, optimizer, dim, slots",
    [
        ("bfloat16", "rowwise_adagrad", 128, {"accumulator": (1001,)}),
        ("bfloat16", "adagrad", 32, {"accumulator": (1001, 32)}),
        ("float32", "sgd", 32, {}),
        ("float32", "adam", 32, {"momentum": (1001, 32),
                                 "velocity": (1001, 32)}),
    ],
)
def test_split_state_layout(dtype, optimizer, dim, slots):
    stack, _ = _stack(1000, dim, dtype, optimizer)
    assert not stack.packed_state
    table = torch.randn(stack.global_rows, dim).to(stack.storage_dtype)
    state = init_stack_state(stack, table)
    assert state["table"] is table and float(state["step"]) == 0.0
    assert {k: tuple(v.shape) for k, v in state["slots"].items()} == slots
    for k, v in state["slots"].items():
        assert v.dtype == torch.float32
        want = stack.optimizer.init_slot(k, v.shape)
        assert torch.equal(v, want)


def test_packed_state_layout_for_adam():
    stack, _ = _stack(1000, 128, "float32", "adam")
    assert stack.packed_state and stack.state_stride == 3
    table = torch.randn(stack.global_rows, 128)
    state = init_stack_state(stack, table)
    assert set(state) == {"table", "step"}
    assert state["table"].shape == (1001, 3, 128)
    assert torch.equal(state["table"][:, 0], table)
    assert state["table"][:, 1:].eq(0).all()


def test_as_tensor_reads_numpy_bf16_bit_for_bit():
    x = np.asarray(jnp.asarray([[1.5, -2.0, 3.0e-3]], jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = as_tensor(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    f = as_tensor(np.arange(3, dtype=np.float32))
    assert f.dtype == torch.float32 and as_tensor(f) is f
