"""The numeric scheme of the tensor-core flash kernels (B5 forward, B6 dQ
and B7 dK/dV in csrc/flash_attention.cu), emulated on the CPU.

For f32 inputs the kernels run every product on the TF32 tensor cores
with error compensation ("3xTF32"): each operand x is split into
big = tf32(x), rounded to nearest, and small = x - big truncated to TF32,
and a product A . B is summed as small_A . big_B + big_A . small_B +
big_A . big_B in f32. The emulation lives here, not in the package: TF32
rounding is round-to-nearest on the magnitude followed by masking the low
13 mantissa bits (what cvt.rna.tf32.f32 does and what the kernels do with
an integer add and a mask), truncation is the mask alone, and the
products are f32 einsums of the parts.

Two halves, at small slice-like shapes (hd 17 / 50 / 64, causal or not):
  * with the split, O, lse, dQ, dK and dV stay within the f32 bounds of
    the kernels' plain versions (forward 1e-5, gradients rtol 1e-4 / atol
    2e-5: the bounds the card is held to);
  * with a single TF32 product they do not, which is why the split is
    there.
"""

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
B, T, H = 2, 136, 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), returned as f32."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the low 13 mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32_truncated(x - big)


def product_3x(eq, a, b):
    """einsum(eq, a, b) as the kernels sum it: small terms first."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return (torch.einsum(eq, a_small, b_big)
            + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def product_1x(eq, a, b):
    return torch.einsum(eq, tf32(a), tf32(b))


def _mask_scores(s, bias, scale, causal):
    s = s * scale + bias[:, None, None, :]
    if causal:
        visible = torch.ones((T, T), dtype=torch.bool).tril()
        s = torch.where(visible, s, torch.full_like(s, tfa.NEG_INF))
    return s


def emulated_forward(product, q, k, v, bias, scale, causal):
    s = _mask_scores(product("bqhd,bkhd->bhqk", q, k), bias, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = product("bhqk,bkhd->bqhd", p, v) / l.permute(0, 2, 1, 3)
    return o, (m + torch.log(l))[..., 0]


def emulated_dq(product, q, k, v, bias, dout, lse, delta, scale, causal):
    """B6: S and dP as two products, dS formed from them in f32, then
    dS . K with dS split like any other A operand (in the kernel it never
    leaves the registers that accumulated dP)."""
    s = _mask_scores(product("bqhd,bkhd->bhqk", q, k), bias, scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = product("bqhd,bkhd->bhqk", dout, v)
    ds = p * (dp - delta[..., None]) * scale
    return product("bhqk,bkhd->bqhd", ds, k)


def emulated_dkv(product, q, k, v, bias, dout, lse, delta, scale, causal):
    s = _mask_scores(product("bqhd,bkhd->bhqk", q, k), bias, scale, causal)
    p = torch.exp(s - lse[..., None])
    dp = product("bqhd,bkhd->bhqk", dout, v)
    ds = p * (dp - delta[..., None]) * scale
    dv = product("bhqk,bqhd->bkhd", p, dout)
    dk = product("bhqk,bqhd->bkhd", ds, q)
    return dk, dv


def _case(hd, causal):
    rng = np.random.default_rng(100 + hd)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((B, T, H, hd)).astype(np.float32))
        for _ in range(3))
    mask = (rng.uniform(size=(B, T)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0  # every query row sees a real key
    bias = tfa.key_bias(torch.from_numpy(mask), B, T, "cpu")
    scale = 1.0 / float(np.sqrt(hd))
    out, lse = tfa.flash_attention_fwd_reference(q, k, v, bias, scale,
                                                 causal)
    dout = torch.cos(out)
    delta = (dout * out).sum(dim=-1).transpose(1, 2).contiguous()
    dk, dv = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, bias, dout, lse, delta, scale, causal)
    dq = tfa.flash_attention_bwd_dq_reference(
        q, k, v, bias, dout, lse, delta, scale, causal)
    return ((q, k, v, bias, scale), (dout, lse, delta), (out, lse, dk, dv),
            dq)


def _emulate(product, case, causal):
    (q, k, v, bias, scale), (dout, lse, delta), *_ = case
    out, got_lse = emulated_forward(product, q, k, v, bias, scale, causal)
    dk, dv = emulated_dkv(product, q, k, v, bias, dout, lse, delta, scale,
                          causal)
    return out, got_lse, dk, dv


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10,
                      -(1.0 + 2.0 ** -11), 3.14159265, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 3.140625, 0.0])
    assert torch.equal(tf32(x), want)
    big, small = split(x)
    assert torch.equal((big.view(torch.int32) & 0x1FFF),
                       torch.zeros(6, dtype=torch.int32))
    assert torch.equal((small.view(torch.int32) & 0x1FFF),
                       torch.zeros(6, dtype=torch.int32))
    # big + small keeps 21 of the 24 mantissa bits.
    torch.testing.assert_close(big + small, x, rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [17, 50, 64])
def test_split_products_stay_within_the_f32_bounds(hd, causal):
    case = _case(hd, causal)
    out, lse, dk, dv = _emulate(product_3x, case, causal)
    want_out, want_lse, want_dk, want_dv = case[2]
    torch.testing.assert_close(out, want_out, **FWD_TOL)
    torch.testing.assert_close(lse, want_lse, **FWD_TOL)
    torch.testing.assert_close(dk, want_dk, **GRAD_TOL)
    torch.testing.assert_close(dv, want_dv, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [17, 50, 64])
def test_single_tf32_product_breaks_the_f32_bounds(hd, causal):
    case = _case(hd, causal)
    got = _emulate(product_1x, case, causal)
    for name, g, w, tol in zip(("O", "lse", "dK", "dV"), got, case[2],
                               (FWD_TOL, FWD_TOL, GRAD_TOL, GRAD_TOL)):
        err = (g - w).abs()
        over = err > tol["atol"] + tol["rtol"] * w.abs()
        assert bool(over.any()), f"{name} within the bound with one product"
        # ... and by a wide margin, not by a rounding at the edge.
        assert float(err.max()) > 10 * tol["atol"], name


def _emulate_dq(product, case, causal):
    (q, k, v, bias, scale), (dout, lse, delta), *_ = case
    return emulated_dq(product, q, k, v, bias, dout, lse, delta, scale,
                       causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [17, 50, 64])
def test_split_dq_stays_within_the_gradient_bound(hd, causal):
    case = _case(hd, causal)
    torch.testing.assert_close(_emulate_dq(product_3x, case, causal),
                               case[3], **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [17, 50, 64])
def test_single_tf32_dq_breaks_the_gradient_bound(hd, causal):
    case = _case(hd, causal)
    got, want = _emulate_dq(product_1x, case, causal), case[3]
    err = (got - want).abs()
    over = err > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs()
    assert bool(over.any()), "dQ within the bound with one product"
    assert float(err.max()) > 10 * GRAD_TOL["atol"]
