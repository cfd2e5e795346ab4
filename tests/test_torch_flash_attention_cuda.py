"""The flash attention kernels (csrc/flash_attention.cu: B5 forward, B6
dQ, B7 dK/dV) against their plain PyTorch versions on the card. Skips
without a CUDA device; imports no JAX, so it runs on a machine that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_attention_cuda.py

Shapes: the SASRec slice (T 1024, hd 50, f32, a quarter of the rows
left-padded) and the long bf16 case (T 4096, H 4, hd 64), both with a
smaller batch; head dims that are and are not a multiple of the tensor
core's depth, in both types, down to 2-byte-aligned rows; several heads;
T of 1, 63, 65, 127, 129, 130 and 200 around the 32- and 64-row ring
tiles and the 128-row query tile; a batch row with no real key. Each
case runs causal and not. Compared
on the query rows that see a real key (the kernel contract); dO is 0 on
the other rows, as in SASRec, so dK and dV agree on every row. Bounds:
f32 O and lse 1e-5, gradients atol 2e-5 / rtol 1e-4 (sums in another
order; TF32 off for the plain versions' products), bf16 3e-2.
"""

import math

import pytest
import torch

from keras_rs_tpu_torch.ops import flash_attention as fa

CASES = {
    "slice_f32": (4, 1024, 1, 50, torch.float32),
    "long_bf16": (1, 4096, 4, 64, torch.bfloat16),
    "ragged_f32": (3, 200, 2, 17, torch.float32),
    "hd128_f32": (2, 130, 1, 128, torch.float32),
    # Rows of 100 and 34 bytes: 4- and 2-byte copies, hd padded to 64, 32.
    "hd50_bf16": (2, 200, 2, 50, torch.bfloat16),
    "hd17_bf16": (2, 130, 2, 17, torch.bfloat16),
    "hd128_bf16": (2, 130, 1, 128, torch.bfloat16),
    # No padding column, one padding-free 16-byte row, and heads apart.
    "hd56_f32": (2, 200, 1, 56, torch.float32),
    "hd64_f32": (2, 256, 2, 64, torch.float32),
    "heads_hd50_f32": (2, 300, 3, 50, torch.float32),
    # Around the 64-row tile.
    "t1_f32": (2, 1, 1, 50, torch.float32),
    "t63_f32": (2, 63, 2, 50, torch.float32),
    "t65_f32": (2, 65, 2, 50, torch.float32),
    "t130_f32": (2, 130, 2, 50, torch.float32),
    "t65_bf16": (2, 65, 2, 64, torch.bfloat16),
    # Around the 128-query tile of B5 and B6.
    "t127_f32": (2, 127, 2, 50, torch.float32),
    "t129_f32": (2, 129, 2, 50, torch.float32),
    "t129_bf16": (2, 129, 1, 64, torch.bfloat16),
    # f32 head dims padded to 8 (one and three MMA steps) and the widest
    # padded instance below 128.
    "hd8_f32": (2, 200, 2, 8, torch.float32),
    "hd24_f32": (2, 200, 1, 24, torch.float32),
    "hd120_f32": (2, 130, 1, 120, torch.float32),
    # Batch row 1 has no real key at all (only finite there).
    "padded_row_f32": (3, 200, 1, 50, torch.float32),
    "padded_row_bf16": (3, 200, 2, 64, torch.bfloat16),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _inputs(B, T, H, hd, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device=device)
                     .to(dtype) for _ in range(4))
    mask = torch.ones((B, T), device=device)
    for row in range(0, B, 4):  # every fourth row left-padded
        mask[row, : T - max(16, T // 3)] = 0
    return q, k, v, dout, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain_versions(cuda, case, causal):
    B, T, H, hd, dtype = CASES[case]
    q, k, v, dout, mask = _inputs(B, T, H, hd, dtype, cuda)
    if case.startswith("padded_row"):
        mask[1] = 0
    bias = fa.key_bias(mask, B, T, cuda)
    scale = 1.0 / math.sqrt(hd)
    rows = fa.rows_with_visible_key(mask, B, T, causal, cuda)
    f32 = dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=3e-2, atol=3e-2)
    gtol = dict(rtol=1e-4, atol=2e-5) if f32 else tol

    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, causal)
    want_out, want_lse = fa.flash_attention_fwd_reference(
        q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out[rows].float(), want_out[rows].float(),
                               **tol)
    torch.testing.assert_close(lse.transpose(1, 2)[rows],
                               want_lse.transpose(1, 2)[rows],
                               rtol=1e-5, atol=1e-5)

    dout = dout * rows[:, :, None, None].to(dtype)
    delta = (dout.float() * want_out.float()).sum(-1).transpose(1, 2)
    delta = delta.contiguous()
    args = (q, k, v, bias, dout, want_lse, delta, scale, causal)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want_dq = fa.flash_attention_bwd_dq_reference(*args)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    assert dq.dtype == dtype and dk.dtype == dv.dtype == torch.float32
    torch.testing.assert_close(dq[rows].float(), want_dq[rows].float(),
                               **gtol)
    torch.testing.assert_close(dk, want_dk, **gtol)
    torch.testing.assert_close(dv, want_dv, **gtol)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                n + 1 for n in before)


@pytest.mark.cuda
def test_autograd_on_cuda_matches_cpu(cuda):
    """The whole Function (kernels) against the same Function on the CPU
    (plain versions), through sum(sin(O)), every key mask keeping key 0."""
    q, k, v, _, mask = _inputs(2, 300, 2, 40, torch.float32, cuda, seed=1)
    mask[:, 0] = 1
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True,
                                 key_mask=mask.to(dev))
        torch.sin(out).sum().backward()
        grads[dev] = [out.detach()] + [t.grad for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-5)


@pytest.mark.cuda
def test_wrapper_rejects_wide_heads_and_strided_inputs(cuda):
    q = torch.zeros((1, 8, 1, 160), device=cuda)
    bias = torch.zeros((1, 8), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q, bias, 1.0, True)
    x = torch.zeros((1, 8, 2, 32), device=cuda)[:, :, :1]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(x, x, x, bias, 1.0, True)
