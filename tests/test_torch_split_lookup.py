"""One stacked-lookup training step of the port against the JAX package's
for the stacks that do not take B1: the split layout (bf16 tables,
row-wise Adagrad, Adagrad, SGD, Adam) and the packed layout's non-fused
branch (Adam, FTRL: gather, apply, B2's plain version).

At dim 32 both packages take the split layout with the same geometry,
so the whole raw state is compared (carried into the port with
convert.load_params(states=...)). At dim 128 a bf16 stack is bit-packed
in the JAX package and plain in the port, so logical tables are
compared, and the row-wise accumulators over the tables' rows.

Tolerances: activations 1e-6 (f32 sums over the valence in another
order). f32 tables and slots rtol 1e-6 / atol 1e-6 (the segment-sum adds
in another order), FTRL atol 2e-5 (tests/test_torch_optimizers.py).
bf16 tables within one bf16 ulp: stochastic rounding draws jax.random's
bits on one side and torch's on the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import (
    assert_within_bf16_ulps,
    jax_stack_states,
    one_device_mesh,
)

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import (
    distributed_embedding as jax_de,
)
from keras_rs_tpu.layers.embedding import optimizers as jax_optimizers
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import distributed_embedding
from keras_rs_tpu_torch.layers.embedding import optimizers
from keras_rs_tpu_torch.ops import row_ops

B = 32
LR = 0.05
# Two stacked tables with different combiners and a weighted feature
# whose zero weights are padding.
TABLES = [("t_a", 500, 3, "sum"), ("t_b", 300, 2, "mean")]


def _configs(cfg_mod, opt_mod, dtype, optimizer, dim):
    opt = opt_mod._BY_NAME[optimizer](learning_rate=LR)
    return {
        f"f_{name}": cfg_mod.FeatureConfig(
            name=f"f_{name}",
            table=cfg_mod.TableConfig(
                name=name, vocabulary_size=vocab, embedding_dim=dim,
                optimizer=opt, combiner=combiner, placement="sharded",
                dtype=dtype, max_ids_per_partition=5 * B,
                max_unique_ids_per_partition=5 * B,
            ),
            input_shape=(B, valence),
            output_shape=(B, dim),
        )
        for name, vocab, valence, combiner in TABLES
    }


def _inputs(dim):
    rng = np.random.default_rng(dim)
    ids = {f"f_{name}": rng.integers(0, vocab, size=(B, valence))
           for name, vocab, valence, _ in TABLES}
    w = rng.uniform(0.5, 2.0, size=(B, 2)).astype(np.float32)
    w[rng.random((B, 2)) < 0.25] = 0.0
    cot = {f"f_{name}": rng.standard_normal((B, dim)).astype(np.float32)
           for name, _, _, _ in TABLES}
    return ids, {"f_t_b": w}, cot


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _step(dtype, optimizer, dim, carry_states):
    """Builds both layers with the same start, runs one forward and one
    update on each, checks the activations; returns (the JAX layer after
    its step, the port's layer after its step)."""
    jlayer = jax_de.DistributedEmbedding(
        _configs(jax_config, jax_optimizers, dtype, optimizer, dim),
        key=jax.random.key(0), mesh=one_device_mesh(),
    )
    tlayer = distributed_embedding.DistributedEmbedding(
        _configs(config, optimizers, dtype, optimizer, dim),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    if carry_states:
        convert.load_params(tlayer, {}, states=jax_stack_states(jlayer))
    else:
        tlayer.set_embedding_tables(jlayer.get_embedding_tables())
    ids, weights, cot = _inputs(dim)
    jpre = jlayer.preprocess(ids, weights)
    j_acts = jax.jit(lambda m, p: m(p))(jlayer, jpre)

    def jloss(m, pre):
        acts = m(pre)
        return sum(jnp.sum(acts[k] * cot[k]) for k in acts)

    opt = optax.sgd(0.0)  # the layer has no dense parameters
    state = jax_training.create_train_state(jlayer, opt)
    step = jax_training.make_train_step(jloss, opt, donate=False)
    state, _ = step(state, jpre)

    before = {k: v.clone() for k, v in tlayer.get_embedding_tables().items()}
    t_acts = tlayer(tlayer.preprocess(ids, weights))
    for k in j_acts:
        np.testing.assert_allclose(_f32(t_acts[k]), _f32(j_acts[k]),
                                   rtol=1e-6, atol=1e-6)
    sum((t_acts[k] * torch.from_numpy(cot[k])).sum()
        for k in t_acts).backward()
    for name, t in tlayer.get_embedding_tables().items():
        assert not torch.equal(t, before[name]), name
    assert len(tlayer.stacks) == 1
    assert float(tlayer.stack_state(0)["step"]) == 1.0
    return state.model, tlayer


def _close(got, want, dtype, atol=1e-6):
    if dtype == "bfloat16":
        assert_within_bf16_ulps(_f32(got), _f32(want), ulps=1.0)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                   atol=atol)


@pytest.mark.parametrize(
    "dtype, optimizer, dim, packed",
    [
        ("bfloat16", "rowwise_adagrad", 32, False),
        ("bfloat16", "adagrad", 32, False),
        ("float32", "sgd", 32, False),
        ("float32", "adam", 32, False),
        ("float32", "adam", 128, True),
        ("float32", "ftrl", 128, True),
    ],
)
def test_update_step_matches_jax_raw_state(dtype, optimizer, dim, packed):
    launches = (row_ops.scatter_rows.launches,
                row_ops._scatter_rows_multi.launches,
                row_ops.scatter_row_blocks.launches)
    jafter, tlayer = _step(dtype, optimizer, dim, carry_states=True)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert launches == (row_ops.scatter_rows.launches,
                        row_ops._scatter_rows_multi.launches,
                        row_ops.scatter_row_blocks.launches)
    stack = tlayer.stacks[0]
    assert stack.packed_state == packed
    j_state = jafter.state.value[stack.name]
    t_state = tlayer.stack_state(0)
    atol = 2e-5 if optimizer == "ftrl" else 1e-6
    assert t_state["table"].dtype == {
        "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    _close(t_state["table"], j_state["table"], dtype, atol)
    assert set(t_state.get("slots", {})) == set(j_state.get("slots", {}))
    for k, v in t_state.get("slots", {}).items():
        assert v.shape == j_state["slots"][k].shape
        np.testing.assert_allclose(_f32(v), _f32(j_state["slots"][k]),
                                   rtol=1e-6, atol=atol)
    assert float(t_state["step"]) == float(j_state["step"]) == 1.0


def test_bf16_dim128_rowwise_step_matches_jax_bitpacked_tables():
    """Capacity mode's stack (bf16, row-wise Adagrad, dim 128): the JAX
    package bit-packs it, the port keeps [R, 128] bf16 rows."""
    jafter, tlayer = _step("bfloat16", "rowwise_adagrad", 128,
                           carry_states=False)
    stack = tlayer.stacks[0]
    assert jafter.stacks[0].bitpacked_state and not stack.packed_state
    j_tables = jafter.get_embedding_tables()
    for name, t in tlayer.get_embedding_tables().items():
        assert t.dtype == torch.bfloat16
        assert_within_bf16_ulps(_f32(t), _f32(j_tables[name]), ulps=1.0)
    # The accumulators of the tables' rows (the JAX stack has two more
    # rows at the end: a dead pair partner and its sink).
    n = sum(t.vocabulary_size for t in stack.tables)
    np.testing.assert_allclose(
        _f32(tlayer.stack_state(0)["slots"]["accumulator"][:n]),
        _f32(jafter.state.value[stack.name]["slots"]["accumulator"][:n]),
        rtol=1e-6, atol=1e-6,
    )
