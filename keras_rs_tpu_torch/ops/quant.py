"""Stochastic rounding for bf16 tables, and int8 serving tables.

Counterpart of keras_rs_tpu/ops/quant.py.

Stochastic rounding (stochastic_round_bf16, cast_rows_for_storage): bf16
is the top 16 bits of f32, so adding 16 uniform random bits to the low
half before truncation rounds up with probability equal to the distance
below: the stored row's expected value is the f32 update, and updates
far below a bf16 ulp still move the table. The bits come from an
explicit torch.Generator; torch cannot draw jax.random's bits, so the
two packages agree within one bf16 ulp, and `stochastic_round_bf16_bits`
takes the bits as an argument so that a test can hold the formula itself
bit for bit.

Int8 serving tables: symmetric per-row quantization (`quantize_rows_int8`,
q int8 [R, dim] and scale f32 [R, 1], |q * scale - x| <= absmax / 254),
bit for bit the JAX package's q and scale, and its two packed layouts,
whose words are the JAX package's words bit for bit:
  * "packed": 4 consecutive rows byte-interleaved per column of one int32
    [ceil(R/4), dim] word row (word[g, d] = q[4g, d] | q[4g+1, d] << 8 |
    q[4g+2, d] << 16 | q[4g+3, d] << 24) and a 1-D [R] scale;
  * "fused" (dim 128): rows 8g..8g+7 in two such 128-word planes, their
    8 scales (f32 bits) and 120 zero words: int32 [ceil(R/8), 384].
The words are built and read through byte views (`Tensor.view(dtype)`):
byte k of a little-endian int32 is its bits 8k..8k+7, on the CPU and on
CUDA alike, so no shift can overflow. The layouts exist in the JAX
package for a TPU gather's costs; on the card they give the same values
as "rows" and are measured against it (PERF.md).
"""

from __future__ import annotations

import torch

#: Rows quantized at once by `quantize_rows_int8_into` (512 MB of f32 at
#: dim 128): a table is quantized chunk by chunk straight from its
#: stored rows, so the f32 copy never exists at full size.
QUANT_CHUNK_ROWS = 1 << 20


def stochastic_round_bf16_bits(
    x: torch.Tensor, bits: torch.Tensor
) -> torch.Tensor:
    """f32 -> bf16 with the given random bits (int32, low 16 used).

    The JAX formula in uint32, `(bits(x) + (r & 0xFFFF)) >> 16`, done in
    int32: the sum of a finite f32's bits and a value below 2^16 does not
    overflow int32, and the arithmetic shift leaves exactly the top 16
    bits as an int16 value, whatever the sign.
    """
    return _add_and_truncate(bits.to(torch.int32) & 0xFFFF, x)


def _add_and_truncate(low: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`low` (int32 in [0, 2^16), overwritten) plus x's bits, top half."""
    low.add_(x.to(torch.float32).contiguous().view(torch.int32))
    return low.bitwise_right_shift_(16).to(torch.int16).view(torch.bfloat16)


def stochastic_round_bf16(
    x: torch.Tensor, generator: torch.Generator | None
) -> torch.Tensor:
    """Rounds f32 -> bf16 stochastically: P(round up) = frac distance."""
    bits = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    return _add_and_truncate(bits.random_(0, 1 << 16, generator=generator), x)


def cast_rows_for_storage(
    x: torch.Tensor, dtype: torch.dtype, generator: torch.Generator | None
) -> torch.Tensor:
    """Casts updated rows to the table's storage dtype: f32 passes
    through; bf16 rounds stochastically with `generator`, or to nearest
    when it is None."""
    if dtype == torch.float32:
        return x.to(torch.float32)
    if dtype == torch.bfloat16:
        if generator is None:
            return x.to(torch.bfloat16)
        return stochastic_round_bf16(x, generator)
    raise ValueError(f"Unsupported table dtype: {dtype}")


def quantize_rows_int8(
    table: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization for inference tables.

    Returns `(q, scale)`: q int8 [R, dim] and scale f32 [R, 1] with
    q * scale ~= table (max abs error <= scale / 2 per element, i.e.
    absmax / 254 per row). Zero rows get scale 1 so they dequantize to
    exactly zero. The rows are taken to f32 first (bf16 exactly), divided
    by absmax / 127 in f32 and rounded half to even, as the JAX package
    does, so q and scale equal its arrays bit for bit.
    """
    x = table.to(torch.float32, copy=True)
    absmax = x.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its rounded reciprocal, one ulp off the true quotient at times.
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, 127.0), 1.0)
    q = x.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows_int8_into(
    rows_of, n_rows: int, q: torch.Tensor, scale: torch.Tensor,
    chunk_rows: int = QUANT_CHUNK_ROWS,
) -> None:
    """Quantizes a table chunk by chunk into preallocated `q` [n, dim]
    int8 and `scale` [n, 1] f32: `rows_of(lo, hi)` returns rows [lo, hi)
    in any float type. Per-row quantization, so the chunks give the
    whole-table result exactly."""
    for lo in range(0, n_rows, chunk_rows):
        hi = min(lo + chunk_rows, n_rows)
        q[lo:hi], scale[lo:hi] = quantize_rows_int8(rows_of(lo, hi))


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_rows_int8` (up to rounding)."""
    return q.to(torch.float32) * scale


def _pad_rows(x: torch.Tensor, multiple: int, value) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    fill = x.new_full((pad,) + tuple(x.shape[1:]), value)
    return torch.cat([x, fill])


def _lane(words: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Byte `lane` (0-3, broadcast over the last axis) of int32 words,
    sign-extended, as f32: the reference's `(w << (24 - 8k)) >> 24`."""
    shift = (8 * lane).to(torch.int32)
    byte = torch.bitwise_and(torch.bitwise_right_shift(words, shift), 0xFF)
    return byte.to(torch.uint8).view(torch.int8).to(torch.float32)


def pack_rows_int8_groups(q: torch.Tensor) -> torch.Tensor:
    """int8 [R, dim] -> int32 [ceil(R/4), dim]: 4 consecutive rows
    byte-interleaved per column (word[g, d] = q[4g, d] | q[4g+1, d] << 8
    | q[4g+2, d] << 16 | q[4g+3, d] << 24). R pads to a multiple of 4
    with zero rows."""
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(
            f"expected int8 [R, dim], got {q.dtype} {tuple(q.shape)}"
        )
    dim = q.shape[1]
    q = _pad_rows(q, 4, 0)
    # Byte k of word [g, d] is q[4g + k, d].
    return (q.view(-1, 4, dim).transpose(1, 2).contiguous()
            .view(torch.int32).view(-1, dim))


def unpack_rows_int8_groups(packed: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of `pack_rows_int8_groups` (drops the padding rows)."""
    g, dim = packed.shape
    return (packed.contiguous().view(torch.int8).view(g, dim, 4)
            .transpose(1, 2).reshape(g * 4, dim)[:rows])


def take_rows_int8_packed(
    packed: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Dequantized f32 rows (ids.shape + (dim,)) from the group-packed
    layout and its 1-D [R] scale. Out-of-range ids clip as the JAX
    package's `mode="clip"` does: the group of id // 4 (floor) and the
    scale of id clip to their ranges, so -1 reads row 3 of group 0 with
    row 0's scale."""
    dim = packed.shape[1]
    flat = ids.reshape(-1).long()
    group = torch.div(flat, 4, rounding_mode="floor").clamp(
        0, packed.shape[0] - 1)
    rows = _lane(packed[group], torch.remainder(flat, 4)[:, None])
    out = rows * scale[flat.clamp(0, scale.shape[0] - 1)][:, None]
    return out.reshape(tuple(ids.shape) + (dim,))


def pack_rows_int8_fused(q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """int8 [R, 128] + f32 [R] scales -> int32 [ceil(R/8), 384]: rows
    8g..8g+7 in two 128-word planes (plane p word d holds rows
    8g+4p..8g+4p+3 at column d, little-endian bytes), their 8 scales as
    f32 bits and 120 zero words. R pads to a multiple of 8 with zero rows
    and scale 1."""
    scale = scale.to(torch.float32).reshape(-1)
    if q.dtype != torch.int8 or q.ndim != 2 or q.shape[1] != 128:
        raise ValueError(
            f"expected int8 [R, 128], got {q.dtype} {tuple(q.shape)}"
        )
    if scale.shape[0] != q.shape[0]:
        raise ValueError(
            f"scale rows {scale.shape[0]} != table rows {q.shape[0]}"
        )
    q = _pad_rows(q, 8, 0)
    scale = _pad_rows(scale, 8, 1.0)
    G = q.shape[0] // 8
    planes = (q.view(G, 2, 4, 128).transpose(2, 3).contiguous()
              .view(torch.int32).view(G, 256))
    scales8 = scale.view(G, 8).view(torch.int32)
    pad = torch.zeros((G, 120), dtype=torch.int32, device=q.device)
    return torch.cat([planes, scales8, pad], dim=1)


def unpack_rows_int8_fused(
    packed: torch.Tensor, rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `pack_rows_int8_fused` (drops the padding rows)."""
    G = packed.shape[0]
    planes = packed[:, :256].contiguous().view(torch.int8)
    q = planes.view(G, 2, 128, 4).transpose(2, 3).reshape(G * 8, 128)
    scale = packed[:, 256:264].contiguous().view(torch.float32).reshape(-1)
    return q[:rows], scale[:rows]


def take_rows_int8_fused(packed: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """Dequantized f32 rows (ids.shape + (128,)) from the fused layout:
    one gather of a [384]-word group row per id brings the row and its
    scale. Out-of-range ids clip as in the JAX package: the group of
    id // 8 (floor) clips to its range and the row in it is id % 8, so
    -1 reads row 7 of group 0 with its own scale."""
    flat = ids.reshape(-1).long()
    w = packed[torch.div(flat, 8, rounding_mode="floor").clamp(
        0, packed.shape[0] - 1)]  # [N, 384]
    k = torch.remainder(flat, 8)[:, None]
    plane = torch.where(k < 4, w[:, :128], w[:, 128:256])
    scale = w[:, 256:264].view(torch.float32).gather(1, k)
    out = _lane(plane, torch.remainder(k, 4)) * scale
    return out.reshape(tuple(ids.shape) + (128,))
