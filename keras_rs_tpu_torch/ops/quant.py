"""Stochastic rounding of updated rows to a bf16 table's storage type.

Counterpart of keras_rs_tpu/ops/quant.py (stochastic_round_bf16,
cast_rows_for_storage). bf16 is the top 16 bits of f32, so adding 16
uniform random bits to the low half before truncation rounds up with
probability equal to the distance below: the stored row's expected value
is the f32 update, and updates far below a bf16 ulp still move the
table. The bits come from an explicit torch.Generator; torch cannot draw
jax.random's bits, so the two packages agree within one bf16 ulp, and
`stochastic_round_bf16_bits` takes the bits as an argument so that a test
can hold the formula itself bit for bit.

The int8 functions of the JAX module are not ported yet.
"""

from __future__ import annotations

import torch


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
