"""Stochastic rounding of bf16 rows (keras_rs_tpu_torch/ops/quant.py):
bit-exact against a numpy transcription of the JAX formula
(keras_rs_tpu/ops/quant.py:19-30) on fixed bits, and the JAX package's
own properties (tests/test_bf16_tables.py:21-46) on drawn bits.
"""

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu_torch.ops import quant


def _numpy_formula(x: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """The JAX formula in uint32 numpy; returns the bf16 bits (uint16)."""
    xi = x.astype(np.float32).view(np.uint32)
    rounded = xi + (bits.astype(np.uint32) & np.uint32(0xFFFF))
    return (rounded >> np.uint32(16)).astype(np.uint16)


def _values(rng, n):
    """Random magnitudes, both signs, and values just below, at and above
    powers of two (where a carry crosses into the exponent), zeros,
    subnormals and the largest finite f32."""
    p = np.float32(2.0) ** np.arange(-20, 21, dtype=np.float32)
    edges = np.concatenate([
        p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf)),
        [0.0, 1e-40, np.finfo(np.float32).max, np.finfo(np.float32).tiny],
    ]).astype(np.float32)
    x = np.concatenate([
        edges,
        (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)),
    ]).astype(np.float32)
    return np.concatenate([x, -x])


@pytest.mark.parametrize("seed", [0, 1])
def test_bits_formula_is_bit_exact_with_numpy(seed):
    rng = np.random.default_rng(seed)
    x = _values(rng, 5000)
    bits = rng.integers(-(2**31), 2**31, size=x.shape, dtype=np.int64)
    bits[:20] = -1  # all 32 bits set: the mask must drop the top 16
    bits[20:40] = 0xFFFF
    want = _numpy_formula(x, bits.astype(np.uint32))
    got = quant.stochastic_round_bf16_bits(
        torch.from_numpy(x), torch.from_numpy(bits.astype(np.int32))
    )
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_stochastic_round_is_unbiased():
    """A half-ulp value (ulp 2^-7 at 1.0) rounds up about half the time,
    a quarter-ulp value about a quarter; the mean is kept."""
    g = torch.Generator().manual_seed(0)
    mid = 1.0 + 2.0**-8
    out = quant.stochastic_round_bf16(torch.full((20000,), mid), g).float()
    up = float((out > mid).float().mean())
    assert 0.45 < up < 0.55, up
    np.testing.assert_allclose(float(out.mean()), mid, rtol=1e-4)
    q = 1.0 + 2.0**-9
    out_q = quant.stochastic_round_bf16(torch.full((20000,), q), g).float()
    up_q = float((out_q > q).float().mean())
    assert 0.20 < up_q < 0.30, up_q
    neg = quant.stochastic_round_bf16(torch.full((20000,), -mid), g).float()
    assert 0.45 < float((neg < -mid).float().mean()) < 0.55


def test_exact_values_pass_through():
    x = torch.tensor([1.0, -2.0, 0.0, 0.5, 3.0 * 2.0**-100])
    out = quant.stochastic_round_bf16(x, torch.Generator().manual_seed(1))
    assert torch.equal(out.float(), x)


def test_same_generator_seed_repeats_and_cast_rows_for_storage():
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(2))
    a = quant.cast_rows_for_storage(
        x, torch.bfloat16, torch.Generator().manual_seed(7))
    b = quant.cast_rows_for_storage(
        x, torch.bfloat16, torch.Generator().manual_seed(7))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    # Every value is x truncated to bf16, or the next bf16 away from 0.
    trunc = (x.view(torch.int32) >> 16).int()
    step = a.view(torch.int16).int() - trunc
    assert ((step == 0) | (step == 1)).all() and step.any()
    assert torch.equal(quant.cast_rows_for_storage(x, torch.bfloat16, None),
                       x.to(torch.bfloat16))
    assert torch.equal(quant.cast_rows_for_storage(x, torch.float32, None), x)
    with pytest.raises(ValueError):
        quant.cast_rows_for_storage(x, torch.float16, None)
