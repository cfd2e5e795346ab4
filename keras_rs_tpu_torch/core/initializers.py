"""Parameter initializers (counterpart of keras_rs_tpu/core/initializers.py).

Same Keras semantics as the JAX package, drawn from an explicit
`torch.Generator` instead of a `jax.random` key. The two frameworks give
different numbers from the same seed, so parity tests move parameters
across with `convert.py` rather than re-drawing them.

Every initializer of the JAX package is here, with its names for `get`
and its `get_config`; `serialize` / `deserialize` round-trip them as
{"class_name", "config"} dicts. Truncated draws are cut at two standard
deviations of the untruncated normal, as jax.random.truncated_normal(-2,
2) is.
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

    def get_config(self) -> dict[str, Any]:
        return {}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "Initializer":
        return cls(**config)


def _truncated(shape, dtype, device, generator, mean: float,
               stddev: float) -> torch.Tensor:
    """mean + stddev * (a unit normal truncated to [-2, 2])."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return torch.nn.init.trunc_normal_(
        out, mean, stddev, mean - 2.0 * stddev, mean + 2.0 * stddev,
        generator=generator,
    )


def _normal(shape, dtype, device, generator, mean: float,
            stddev: float) -> torch.Tensor:
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return out.normal_(mean, stddev, generator=generator)


class Zeros(Initializer):
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return torch.zeros(tuple(shape), dtype=dtype, device=device)


class Ones(Initializer):
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return torch.ones(tuple(shape), dtype=dtype, device=device)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)

    def get_config(self):
        return {"value": self.value}


class RandomNormal(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 0.05):
        self.mean = mean
        self.stddev = stddev

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return _normal(shape, dtype, device, generator, self.mean,
                       self.stddev)

    def get_config(self):
        return {"mean": self.mean, "stddev": self.stddev}


class TruncatedNormal(Initializer):
    """mean + stddev * a unit normal truncated to [-2, 2] (the stddev is
    the untruncated one, as in the JAX package)."""

    def __init__(self, mean: float = 0.0, stddev: float = 0.05):
        self.mean = mean
        self.stddev = stddev

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        return _truncated(shape, dtype, device, generator, self.mean,
                          self.stddev)

    def get_config(self):
        return {"mean": self.mean, "stddev": self.stddev}


class RandomUniform(Initializer):
    def __init__(self, minval: float = -0.05, maxval: float = 0.05):
        self.minval = minval
        self.maxval = maxval

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None, fan_shape=None):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.uniform_(self.minval, self.maxval, generator=generator)

    def get_config(self):
        return {"minval": self.minval, "maxval": self.maxval}


class VarianceScaling(Initializer):
    """Keras-compatible VarianceScaling (scale / fan is the variance);
    "truncated_normal" divides the stddev by the truncation's shrink so
    that the drawn values have the requested variance."""

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
        if distribution not in ("truncated_normal", "normal", "uniform",
                                "untruncated_normal"):
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
        if self.distribution == "truncated_normal":
            stddev = math.sqrt(variance) / _TRUNCATED_STD_CORRECTION
            return _truncated(shape, dtype, device, generator, 0.0, stddev)
        if self.distribution in ("normal", "untruncated_normal"):
            return _normal(shape, dtype, device, generator, 0.0,
                           math.sqrt(variance))
        limit = math.sqrt(3.0 * variance)
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)

    def get_config(self):
        return {
            "scale": self.scale,
            "mode": self.mode,
            "distribution": self.distribution,
        }


class _Fixed(VarianceScaling):
    """A VarianceScaling with fixed arguments (config {})."""

    ARGS: tuple = ()

    def __init__(self):
        super().__init__(*self.ARGS)

    def get_config(self):
        return {}


class GlorotUniform(_Fixed):
    ARGS = (1.0, "fan_avg", "uniform")


class GlorotNormal(_Fixed):
    ARGS = (1.0, "fan_avg", "truncated_normal")


class HeUniform(_Fixed):
    ARGS = (2.0, "fan_in", "uniform")


class HeNormal(_Fixed):
    ARGS = (2.0, "fan_in", "truncated_normal")


_ALIASES = {
    "zeros": Zeros,
    "ones": Ones,
    "random_normal": RandomNormal,
    "random_uniform": RandomUniform,
    "truncated_normal": TruncatedNormal,
    "variance_scaling": VarianceScaling,
    "glorot_uniform": GlorotUniform,
    "glorot_normal": GlorotNormal,
    "he_uniform": HeUniform,
    "he_normal": HeNormal,
}
_BY_CLASS_NAME = {cls.__name__: cls
                  for cls in (*_ALIASES.values(), Constant)}


def get(identifier: Any) -> Initializer:
    """Resolve a name, an Initializer or a callable (returned as it is,
    called like an Initializer)."""
    if isinstance(identifier, Initializer):
        return identifier
    if isinstance(identifier, str):
        name = identifier.lower()
        if name not in _ALIASES:
            raise ValueError(f"Unknown initializer: {identifier!r}")
        return _ALIASES[name]()
    if callable(identifier):
        return identifier
    raise ValueError(f"Cannot interpret initializer: {identifier!r}")


def serialize(initializer: Initializer) -> dict[str, Any]:
    return {
        "class_name": type(initializer).__name__,
        "config": initializer.get_config(),
    }


def deserialize(spec: Any) -> Initializer:
    """A name (as `get`) or a `serialize` dict -> Initializer."""
    if isinstance(spec, str):
        return get(spec)
    return _BY_CLASS_NAME[spec["class_name"]].from_config(spec["config"])
