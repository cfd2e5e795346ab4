"""The port's fused attention (ops/flash_attention.py) on the CPU, where
the autograd Function runs the plain versions of kernels B5-B7, against
the JAX package's Pallas kernels (interpret mode) and its oracle
`attention_reference`.

Shapes mirror tests/test_flash_attention.py. Inputs come from numpy with
a seed; every key mask keeps key 0, so every query row sees a real key
(the rows the kernel contract covers). Bounds: f32 forward 1e-5, f32
gradients atol 2e-5 / rtol 1e-4 (the JAX tests' bounds; the sums run in
another order), bf16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.ops import flash_attention as jfa
from keras_rs_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _inputs(B, T, H, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    return q, k, v, mask


def _t(*arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_mask", [True, False])
def test_forward_matches_jax(causal, use_mask):
    q, k, v, mask = _inputs(2, 200, 4, 48, seed=0)
    m = mask if use_mask else None
    want = np.asarray(jfa.flash_attention(
        q, k, v, causal=causal, key_mask=m, interpret=True))
    oracle = np.asarray(jfa.attention_reference(
        q, k, v, causal=causal, key_mask=m))
    tq, tk, tv = _t(q, k, v)
    got = tfa.flash_attention(
        tq, tk, tv, causal=causal,
        key_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **FWD_TOL)
    ref = tfa.attention_reference(
        tq, tk, tv, causal=causal,
        key_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(ref.numpy(), oracle, **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v, mask = _inputs(2, 136, 2, 32, seed=1)

    def loss(fn):
        return lambda q, k, v: jnp.sum(jnp.sin(
            fn(q, k, v, causal=causal, key_mask=mask)))

    flash = lambda *a, **kw: jfa.flash_attention(  # noqa: E731
        *a, **kw, interpret=True)
    want = jax.grad(loss(flash), (0, 1, 2))(q, k, v)
    oracle = jax.grad(loss(jfa.attention_reference), (0, 1, 2))(q, k, v)

    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              key_mask=torch.from_numpy(mask))
    torch.sin(out).sum().backward()
    for t, w, o in zip((tq, tk, tv), want, oracle):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(o),
                                   **GRAD_TOL)


def test_bf16_inputs():
    q, k, v, mask = _inputs(1, 128, 2, 64, seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    oracle = jfa.attention_reference(jq, jk, jv, causal=True,
                                     key_mask=mask)
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    np.testing.assert_array_equal(  # same bf16 rounding of the inputs
        tq.float().numpy(), np.asarray(jq.astype(jnp.float32)))
    got = tfa.flash_attention(tq, tk, tv, causal=True,
                              key_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(oracle.astype(jnp.float32)),
                               atol=3e-2)


def test_short_sequence():
    # T = 17 < one 64-row kernel tile (and the TPU's 128-row block).
    q, k, v, _ = _inputs(3, 17, 1, 8, seed=3)
    want = np.asarray(jfa.flash_attention(q, k, v, causal=True,
                                          interpret=True))
    got = tfa.flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_jax(causal):
    """Each plain version alone: B5's O and lse, then B6's dQ and B7's
    dK, dV for dO = d sum(sin(O)) / dO = cos(O), against the JAX
    package's gradients."""
    q, k, v, mask = _inputs(2, 136, 2, 32, seed=4)
    scale = 1.0 / np.sqrt(32)
    tq, tk, tv = _t(q, k, v)
    bias = tfa.key_bias(torch.from_numpy(mask), 2, 136, "cpu")
    out, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, bias, scale,
                                                 causal)
    want_out = jfa.flash_attention(q, k, v, causal=causal, key_mask=mask,
                                   interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **FWD_TOL)

    # lse = logsumexp over the visible real keys of the scaled scores.
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
    visible = mask[:, None, None, :] > 0
    if causal:
        visible = visible & np.tril(np.ones((136, 136), bool))
    want_lse = jax.nn.logsumexp(jnp.where(visible, logits, -jnp.inf),
                                axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FWD_TOL)

    dout = torch.cos(out)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    dq = tfa.flash_attention_bwd_dq_reference(tq, tk, tv, bias, dout, lse,
                                              delta, scale, causal)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(
        tq, tk, tv, bias, dout, lse, delta, scale, causal)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jnp.sin(jfa.flash_attention(
            q, k, v, causal=causal, key_mask=mask, interpret=True))),
        (0, 1, 2),
    )(q, k, v)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


def test_wrappers_validate_and_count_no_cpu_launch():
    q, k, v, mask = _inputs(1, 20, 1, 8, seed=5)
    tq, tk, tv = _t(q, k, v)
    bias = tfa.key_bias(torch.from_numpy(mask), 1, 20, "cpu")
    before = tfa.flash_attention_fwd.launches
    tfa.flash_attention_fwd(tq, tk, tv, bias, 0.5, True)
    assert tfa.flash_attention_fwd.launches == before  # plain version
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_fwd(tq, tk, tv, bias[:, :5], 0.5, True)
    with pytest.raises(ValueError, match="one shape"):
        tfa.flash_attention_fwd(tq, tk[:, :5], tv, bias, 0.5, True)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_attention_fwd(tq.double(), tk.double(), tv.double(),
                                bias, 0.5, True)


def test_rows_with_visible_key():
    mask = torch.tensor([[0, 0, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]])
    causal = tfa.rows_with_visible_key(mask, 3, 4, True, "cpu")
    assert causal.tolist() == [[False, False, True, True], [True] * 4,
                               [False] * 4]
    full = tfa.rows_with_visible_key(mask, 3, 4, False, "cpu")
    assert full.tolist() == [[True] * 4, [True] * 4, [False] * 4]
