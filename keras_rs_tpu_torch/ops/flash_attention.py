"""Fused causal attention (counterpart of keras_rs_tpu/ops/flash_attention.py).

The JAX package's three Pallas kernels become three CUDA C++ kernels in
csrc/flash_attention.cu; this module holds their wrappers, their plain
PyTorch versions, the autograd Function that joins them, and the oracle
`attention_reference`:

  B5 `_fwd_kernel`     -> `flash_attention_fwd`      (O and lse)
  B6 `_bwd_dq_kernel`  -> `flash_attention_bwd_dq`   (dQ)
  B7 `_bwd_dkv_kernel` -> `flash_attention_bwd_dkv`  (dK, dV)

Layout: q, k, v, O and dO are contiguous [B, T, H, hd] tensors, f32 or
bf16 (the kernels read them in place, so nothing is transposed or padded
on the host); `bias` is [B, T] f32 (0 for a real key, NEG_INF for a
padded one); lse and delta are [B, H, T] f32. The math is f32 for both
input types. Each wrapper runs its plain version for CPU tensors and
launches its kernel for CUDA tensors, or raises; every launch adds one
to the wrapper's `launches`.

Masking is the TPU kernel's: S = (Q K^T) * scale + bias, then NEG_INF
where a key lies after its query (causal). The plain versions compute
exactly that over all T keys.

Contract between a kernel and its plain version: they agree (to the
summation order of f32) on every query row that sees at least one
causally visible, unpadded key. On any other row both are only finite:
the plain version, like the TPU kernel, averages V over all T keys, while
the kernels skip key tiles that lie wholly after the query tile and so
average over the keys they visit. SASRec never reads such rows: it zeroes
the states of padded positions after every block (models/sasrec.py), so
their output gradient is 0 and they change neither the loss nor any
gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from keras_rs_tpu_torch.kernels import loader

NEG_INF = -1e9
#: The kernels' largest head dim (they pad hd to 32, 64 or 128).
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _masked_scores(q, k, bias, scale, causal) -> torch.Tensor:
    """[B, H, Tq, Tk] f32: (Q K^T) * scale + bias, NEG_INF after the
    diagonal when causal (the TPU kernel's order of operations)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :]
    if causal:
        T = q.shape[1]
        visible = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_fwd_reference(q, k, v, bias, scale: float,
                                  causal: bool):
    """Plain version of B5: returns (O in q's dtype, lse [B, H, T] f32)."""
    s = _masked_scores(q, k, bias, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.permute(0, 2, 1, 3)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_dscores(q, k, v, bias, dout, lse, delta, scale, causal):
    """P = exp(S - lse) and dS = P * (dO V^T - delta) * scale, [B, H, T, T]
    f32, as the TPU backward kernels recompute them."""
    p = torch.exp(_masked_scores(q, k, bias, scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_reference(q, k, v, bias, dout, lse, delta,
                                     scale: float, causal: bool):
    """Plain version of B6: dQ in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, bias, dout, lse, delta, scale,
                               causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, bias, dout, lse, delta,
                                      scale: float, causal: bool):
    """Plain version of B7: (dK, dV) in f32."""
    p, ds = _probs_and_dscores(q, k, v, bias, dout, lse, delta, scale,
                               causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk, dv


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, bias, *rest) -> bool:
    """Validates the arguments; True when they lie on the CPU (plain
    version), False on CUDA (kernel)."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must be [B, T, H, hd] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}."
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or (
        v.dtype != q.dtype
    ):
        raise ValueError(
            f"q, k, v must share a dtype in {sorted(map(str, _DTYPE_CODES))},"
            f" got {q.dtype}, {k.dtype}, {v.dtype}."
        )
    B, T = q.shape[:2]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (B, T):
        raise ValueError(
            f"bias must be float32 {(B, T)}, got {bias.dtype} "
            f"{tuple(bias.shape)}."
        )
    tensors = (q, k, v, bias, *rest)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            "all arguments must share a device; got "
            f"{[str(t.device) for t in tensors]}."
        )
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}.")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(
            f"The CUDA kernels take head_dim <= {MAX_HEAD_DIM}, got "
            f"{q.shape[3]}."
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("The CUDA kernels need contiguous arguments.")
    return False


def _check_bwd(q, dout, lse, delta) -> None:
    B, T, H, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(
            f"dout must match q ({q.dtype} {tuple(q.shape)}), got "
            f"{dout.dtype} {tuple(dout.shape)}."
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T):
            raise ValueError(
                f"{name} must be float32 {(B, H, T)}, got {t.dtype} "
                f"{tuple(t.shape)}."
            )


def flash_attention_fwd(q, k, v, bias, scale: float, causal: bool):
    """B5: (O [B, T, H, hd] in q's dtype, lse [B, H, T] f32)."""
    if _check(q, k, v, bias):
        return flash_attention_fwd_reference(q, k, v, bias, scale, causal)
    B, T, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _kernel_call(
        "krt_flash_fwd", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), scale=scale, causal=causal,
    )
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, bias, dout, lse, delta, scale: float,
                           causal: bool):
    """B6: dQ [B, T, H, hd] in q's dtype."""
    _check_bwd(q, dout, lse, delta)
    if _check(q, k, v, bias, dout, lse, delta):
        return flash_attention_bwd_dq_reference(
            q, k, v, bias, dout, lse, delta, scale, causal
        )
    dq = torch.empty_like(q)
    _kernel_call(
        "krt_flash_bwd_dq", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        scale=scale, causal=causal,
    )
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, dout, lse, delta, scale: float,
                            causal: bool):
    """B7: (dK, dV) [B, T, H, hd] in f32."""
    _check_bwd(q, dout, lse, delta)
    if _check(q, k, v, bias, dout, lse, delta):
        return flash_attention_bwd_dkv_reference(
            q, k, v, bias, dout, lse, delta, scale, causal
        )
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _kernel_call(
        "krt_flash_bwd_dkv", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scale=scale, causal=causal,
    )
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _kernel_call(name: str, q, *pointers, scale: float, causal: bool):
    B, T, H, hd = q.shape
    fn = _kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*pointers, B, T, H, hd, float(scale), int(causal),
                 _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"{name} failed with code {err} (-1: unsupported shape or "
            "dtype; else a cudaError_t)."
        )


_N_POINTERS = {"krt_flash_fwd": 6, "krt_flash_bwd_dq": 8,
               "krt_flash_bwd_dkv": 9}


@functools.cache
def _kernel_fn(name: str):
    fn = getattr(loader.load("flash_attention").lib, name)
    fn.argtypes = (
        [ctypes.c_void_p] * _N_POINTERS[name]  # tensors
        + [ctypes.c_int] * 4  # B, T, H, hd
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int]  # scale, causal, dtype
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Autograd and the public function
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.contiguous()
        # delta = rowsum(dO * O), outside any kernel as in the JAX package.
        delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_attention_bwd_dq(q, k, v, bias, g, lse, delta,
                                    ctx.scale, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, bias, g, lse, delta,
                                         ctx.scale, ctx.causal)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def key_bias(key_mask: torch.Tensor | None, B: int, T: int,
             device) -> torch.Tensor:
    """[B, T] f32 additive key bias: 0 where key_mask > 0, else NEG_INF
    (all 0 without a mask)."""
    if key_mask is None:
        return torch.zeros((B, T), dtype=torch.float32, device=device)
    return torch.where(
        key_mask > 0,
        torch.zeros((), dtype=torch.float32, device=device),
        torch.full((), NEG_INF, dtype=torch.float32, device=device),
    )


def rows_with_visible_key(key_mask: torch.Tensor | None, B: int, T: int,
                          causal: bool, device) -> torch.Tensor:
    """[B, T] bool: the query rows that see at least one real key (key
    j <= i when causal), where kernels and plain versions must agree."""
    if key_mask is None:
        return torch.ones((B, T), dtype=torch.bool, device=device)
    real = key_mask > 0
    if causal:
        return real.to(torch.int32).cumsum(dim=1) > 0
    return real.any(dim=1, keepdim=True).expand(B, T)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused attention. q, k, v: [B, T, H, hd]; key_mask: [B, T] (1 = real
    key). Returns [B, T, H, hd] in q's dtype; differentiable in q, k, v.
    CUDA tensors go through kernels B5-B7, CPU tensors through their plain
    versions."""
    B, T, _, hd = q.shape
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    bias = key_bias(key_mask, B, T, q.device)
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bias, float(scale),
        bool(causal),
    )


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    key_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Unfused attention with `where` masking (the oracle of the JAX
    package's tests)."""
    T, hd = q.shape[1], q.shape[3]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=q.device)
    if causal:
        visible = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(visible, logits, neg)
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :] != 0, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
