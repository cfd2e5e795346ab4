"""The port's DLRM-DCNv2 against the JAX package's, from identical
parameters (moved with keras_rs_tpu_torch.convert), on one device.

Tolerances:
  * f32 (compute_dtype=None, dense_output_dtype="float32"): logits and
    the loss of 3 training steps within 1e-5. Both run the same f32
    formulas; what differs is summation order (matmuls, the
    segment-sum) and rsqrt, a few f32 ulp per step.
  * bf16 default (bf16 operands, bf16-resident activations): 5e-3 on
    logits and losses. bf16 keeps 8 bits of mantissa (relative step
    2^-8 ~ 0.4%), and jnp.matmul with preferred_element_type=f32 adds
    the bias to the f32 accumulator where a bf16 torch.matmul rounds to
    bf16 first, so the two packages round at different points through
    the 5-7 layer stack (measured on CPU: 1e-3 on logits of magnitude
    0.3, 2e-4 on the losses).
  * capacity mode (bf16 tables, row-wise Adagrad; f32 dense stack), 3
    steps: losses within 1e-4 (measured 1.5e-5 over two seeds), tables
    within 3 bf16 ulp (one per step: each package rounds its updates
    stochastically with its own random bits) plus 1e-4 absolute (an
    element whose summed gradient nearly cancels takes an update that
    the packages' f32 differences change in relative terms; measured
    5.9e-5 beyond 3 ulp), row-wise accumulators rtol 1e-4.
"""

import numpy as np
import pytest
import torch
from torch_parity import (
    B,
    LR,
    MULTI_HOT,
    VOCAB,
    bf16_ulp,
    build_pair,
    train_jax,
    train_torch,
)

from keras_rs_tpu_torch.data import synthetic

F32 = dict(compute_dtype=None, dense_output_dtype="float32")
CASES = [
    pytest.param(F32, 1e-5, id="f32"),
    pytest.param({}, 5e-3, id="bf16_default"),
]


def _batch(seed):
    return synthetic.criteo_like_batch(
        B, vocab_sizes=VOCAB, multi_hot_sizes=MULTI_HOT, seed=seed
    )


@pytest.mark.parametrize("overrides, tol", CASES)
def test_dlrm_logits_match_jax(overrides, tol):
    jmodel, tmodel = build_pair(seed=1, **overrides)
    raw = _batch(seed=3)
    j_logits = np.asarray(jmodel(jmodel.preprocess(raw)), np.float32)
    with torch.no_grad():
        t_logits = tmodel(tmodel.preprocess(raw)).float().numpy()
    assert t_logits.shape == (B,)
    np.testing.assert_allclose(t_logits, j_logits, rtol=tol, atol=tol)


@pytest.mark.parametrize("overrides, tol", CASES)
def test_dlrm_three_step_losses_match_jax(overrides, tol):
    jmodel, tmodel = build_pair(seed=2, **overrides)
    batches = [_batch(seed=s) for s in (10, 11, 10)]
    j_losses, j_after = train_jax(jmodel, LR, batches)
    t_losses = train_torch(tmodel, LR, batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol, atol=tol)
    # The in-place Overwrite updates landed on both sides: the stacked
    # tables moved off their start and agree.
    j_tables = j_after.embedding_layer.get_embedding_tables()
    t_tables = tmodel.embedding_layer.get_embedding_tables()
    for name, t in t_tables.items():
        np.testing.assert_allclose(
            t.numpy(), np.asarray(j_tables[name]), rtol=tol, atol=tol
        )
    assert float(tmodel.embedding_layer.stack_state(0)["step"]) == 3.0


def test_dlrm_trains_on_fixed_batch():
    _, tmodel = build_pair(seed=0)
    losses = train_torch(tmodel, LR, [_batch(seed=0)] * 6)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


CAPACITY = dict(F32, table_dtype="bfloat16",
                embedding_optimizer="rowwise_adagrad")


@pytest.mark.parametrize(
    "dim, carry_states",
    [pytest.param(32, True, id="dim32_states"),
     pytest.param(128, False, id="dim128_tables")],
)
def test_capacity_mode_three_steps_track_jax(dim, carry_states):
    """At dim 32 both packages lay the stack out alike and the whole
    state is carried; at dim 128 the JAX package bit-packs the bf16 table
    and the logical tables are carried."""
    jmodel, tmodel = build_pair(seed=2, carry_states=carry_states,
                                embedding_dim=dim, bottom_mlp=(64, dim),
                                **CAPACITY)
    emb = tmodel.embedding_layer
    (stack,) = emb.stacks
    assert stack.dtype == "bfloat16" and not stack.packed_state
    assert stack.optimizer.name == "rowwise_adagrad"
    batches = [_batch(seed=s) for s in (10, 11, 10)]
    j_losses, j_after = train_jax(jmodel, LR, batches)
    t_losses = train_torch(tmodel, LR, batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-4)
    assert t_losses[2] < t_losses[0]
    j_tables = j_after.embedding_layer.get_embedding_tables()
    for name, t in emb.get_embedding_tables().items():
        assert t.dtype == torch.bfloat16
        a = t.float().numpy()
        b = np.asarray(j_tables[name]).astype(np.float32)
        bound = 3 * bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + 1e-4
        assert (np.abs(a - b) <= bound).all(), name
    state = emb.stack_state(0)
    assert float(state["step"]) == 3.0
    n = sum(t.vocabulary_size for t in stack.tables)
    j_acc = j_after.embedding_layer.state.value[stack.name]["slots"]
    np.testing.assert_allclose(
        state["slots"]["accumulator"][:n].numpy(),
        np.asarray(j_acc["accumulator"])[:n], rtol=1e-4,
    )
