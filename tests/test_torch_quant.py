"""Stochastic rounding of bf16 rows (keras_rs_tpu_torch/ops/quant.py):
bit-exact against a numpy transcription of the JAX formula
(keras_rs_tpu/ops/quant.py:19-30) on fixed bits. The JAX package's own
properties (tests/test_bf16_tables.py:21-46) on drawn bits are held on
the bits the split update draws, in tests/test_torch_split_update.py.
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
