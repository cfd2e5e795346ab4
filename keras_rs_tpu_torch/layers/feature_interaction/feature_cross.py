"""DCNv2 FeatureCross layer (counterpart of
keras_rs_tpu/layers/feature_interaction/feature_cross.py):

    x_{i+1} = x0 * (pre_activation(x W + b) + diag_scale * x) + x

with W full rank ([dim, dim]) or, given `projection_dim`, low rank:
W = down_proj_kernel [dim, projection_dim] @ kernel [projection_dim,
dim]. Kernels keep the JAX [in, out] layout; mixed precision as in
layers/dense.py.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.core import regularizers as reg_lib
from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.layers.dense import _dtype, regularizers_of
from keras_rs_tpu_torch.utils.device import resolve_device


@export("keras_rs_tpu_torch.layers.FeatureCross")
class FeatureCross(nn.Module):
    """A DCNv2 cross layer with f32 parameters.

    Args:
        dim: the width of x0 and x.
        projection_dim: None for the full-rank [dim, dim] kernel, else the
            rank of the factorized kernel.
        diag_scale: >= 0; adds diag_scale * x to the projection.
        use_bias: whether the projection adds a bias.
        pre_activation: applied to the projection before the diag term.
        kernel_initializer, bias_initializer: names or initializers.
        kernel_regularizer: penalizes both kernels of the low-rank form;
        bias_regularizer: the bias.
    """

    def __init__(
        self,
        dim: int,
        *,
        projection_dim: int | None = None,
        diag_scale: float | None = 0.0,
        use_bias: bool = True,
        pre_activation: Callable[[torch.Tensor], torch.Tensor] | None = None,
        kernel_initializer: Any = "glorot_uniform",
        bias_initializer: Any = "zeros",
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        generator: torch.Generator | None = None,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__()
        if diag_scale is not None and diag_scale < 0.0:
            raise ValueError(
                "`diag_scale` should be non-negative. Received: "
                f"`diag_scale={diag_scale}`"
            )
        device = resolve_device(device)
        kinit = initializers.get(kernel_initializer)
        f32 = torch.float32
        if projection_dim is not None:
            self.down_proj_kernel = nn.Parameter(
                kinit((dim, projection_dim), f32, device, generator)
            )
            self.kernel = nn.Parameter(
                kinit((projection_dim, dim), f32, device, generator)
            )
        else:
            self.register_parameter("down_proj_kernel", None)
            self.kernel = nn.Parameter(kinit((dim, dim), f32, device,
                                             generator))
        if use_bias:
            self.bias = nn.Parameter(initializers.get(bias_initializer)(
                (dim,), f32, device, generator))
        else:
            self.register_parameter("bias", None)
        self.dim = dim
        self.projection_dim = projection_dim
        self.diag_scale = diag_scale
        self.use_bias = use_bias
        self.pre_activation = pre_activation
        self.kernel_regularizer = reg_lib.get(kernel_regularizer)
        self.bias_regularizer = reg_lib.get(bias_regularizer)
        self._regularizers = regularizers_of(
            kernel=self.kernel_regularizer,
            down_proj_kernel=(self.kernel_regularizer
                              if projection_dim is not None else None),
            bias=self.bias_regularizer if use_bias else None,
        )
        self.compute_dtype = _dtype(compute_dtype)
        # Cast `out` before the x0 * out + x combine so a bf16 residual
        # stream stays bf16.
        self.output_dtype = _dtype(output_dtype)
        self.name = name or "feature_cross"

    def _matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            return torch.matmul(
                x.to(self.compute_dtype), w.to(self.compute_dtype)
            ).to(w.dtype)
        return torch.matmul(x, w)

    def forward(
        self, x0: torch.Tensor, x: torch.Tensor | None = None
    ) -> torch.Tensor:
        if x is None:
            x = x0
        if x0.shape != x.shape:
            raise ValueError(
                "`x0` and `x` should have the same shape. Received: "
                f"`x.shape` = {tuple(x.shape)}, "
                f"`x0.shape` = {tuple(x0.shape)}"
            )
        out = x
        if self.down_proj_kernel is not None:
            out = self._matmul(out, self.down_proj_kernel)
        out = self._matmul(out, self.kernel)
        if self.bias is not None:
            out = out + self.bias
        if self.pre_activation is not None:
            out = self.pre_activation(out)
        if self.diag_scale:
            out = out + self.diag_scale * x
        if self.output_dtype is not None:
            out = out.to(self.output_dtype)
        return x0 * out + x

    def get_config(self) -> dict[str, Any]:
        return {
            "dim": self.dim,
            "projection_dim": self.projection_dim,
            "diag_scale": self.diag_scale,
            "kernel_regularizer": reg_lib.serialize(self.kernel_regularizer),
            "bias_regularizer": reg_lib.serialize(self.bias_regularizer),
            "name": self.name,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "FeatureCross":
        """`config` may add run-time arguments (`device`, `generator`)."""
        config = dict(config)
        for key in ("kernel_regularizer", "bias_regularizer"):
            config[key] = reg_lib.deserialize(config.get(key))
        return cls(**config)
