"""Parameter initializers (counterpart of keras_rs_tpu/core/initializers.py).

Same Keras semantics as the JAX package, drawn from an explicit
`torch.Generator` instead of a `jax.random` key. The two frameworks give
different numbers from the same seed, so parity tests move parameters
across with `convert.py` rather than re-drawing them.

Only the initializers the DLRM and SASRec slices name are ported: zeros,
random_uniform (EmbedReduce's default), glorot_uniform (Dense,
FeatureCross and attention kernels, SASRec's item and position
embeddings) and VarianceScaling with truncated-normal or uniform draws
(TableConfig's default is fan_out truncated normal).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from keras_rs_tpu_torch.types import Shape

# Stddev of a unit normal truncated to [-2, 2]; Keras divides by this so the
# post-truncation standard deviation matches the requested one.
_TRUNCATED_STD_CORRECTION = 0.87962566103423978


def _compute_fans(shape: Shape) -> tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


class Initializer:
    """`init(shape, dtype, device, generator, fan_shape) -> Tensor`.

    `generator` must live on `device` (torch draws on the generator's
    device). `fan_shape` (default `shape`) is the shape whose fans scale
    the draw, so that a chunk of rows of a larger table is drawn with the
    whole table's variance.
    """

    def __call__(
        self,
        shape: Shape,
        dtype: torch.dtype = torch.float32,
        device: Any = None,
        generator: torch.Generator | None = None,
        fan_shape: Shape | None = None,
    ) -> torch.Tensor:
        raise NotImplementedError


class Zeros(Initializer):
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)


class RandomUniform(Initializer):
    def __init__(self, minval: float = -0.05, maxval: float = 0.05):
        self.minval = minval
        self.maxval = maxval

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.uniform_(self.minval, self.maxval, generator=generator)


class VarianceScaling(Initializer):
    """Keras-compatible VarianceScaling (scale / fan is the variance)."""

    def __init__(
        self,
        scale: float = 1.0,
        mode: str = "fan_in",
        distribution: str = "truncated_normal",
    ):
        if scale <= 0.0:
            raise ValueError(f"`scale` must be positive, got {scale}.")
        if mode not in ("fan_in", "fan_out", "fan_avg"):
            raise ValueError(f"Invalid `mode`: {mode}")
        if distribution not in ("truncated_normal", "uniform"):
            raise ValueError(f"Invalid `distribution`: {distribution}")
        self.scale = scale
        self.mode = mode
        self.distribution = distribution

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        fan_in, fan_out = _compute_fans(
            shape if fan_shape is None else fan_shape
        )
        if self.mode == "fan_in":
            denom = max(1.0, fan_in)
        elif self.mode == "fan_out":
            denom = max(1.0, fan_out)
        else:
            denom = max(1.0, (fan_in + fan_out) / 2.0)
        variance = self.scale / denom
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        if self.distribution == "truncated_normal":
            stddev = math.sqrt(variance) / _TRUNCATED_STD_CORRECTION
            return torch.nn.init.trunc_normal_(
                out, 0.0, stddev, -2.0 * stddev, 2.0 * stddev,
                generator=generator,
            )
        limit = math.sqrt(3.0 * variance)
        return out.uniform_(-limit, limit, generator=generator)


class GlorotUniform(VarianceScaling):
    def __init__(self):
        super().__init__(scale=1.0, mode="fan_avg", distribution="uniform")


_ALIASES = {
    "zeros": Zeros,
    "random_uniform": RandomUniform,
    "variance_scaling": VarianceScaling,
    "glorot_uniform": GlorotUniform,
}


def get(identifier: Any) -> Initializer:
    """Resolve a string or an Initializer instance."""
    if isinstance(identifier, Initializer):
        return identifier
    if isinstance(identifier, str):
        name = identifier.lower()
        if name not in _ALIASES:
            raise ValueError(f"Unknown initializer: {identifier!r}")
        return _ALIASES[name]()
    raise ValueError(f"Cannot interpret initializer: {identifier!r}")
