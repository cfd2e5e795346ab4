"""DCNv2 FeatureCross layer (counterpart of
keras_rs_tpu/layers/feature_interaction/feature_cross.py):

    x_{i+1} = x0 * (x U V + b) + x

in its low-rank form (U: [dim, projection_dim], V: [projection_dim, dim]).
Kernels keep the JAX [in, out] layout; mixed precision as in
layers/dense.py.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.layers.dense import _dtype
from keras_rs_tpu_torch.utils.device import resolve_device


class FeatureCross(nn.Module):
    """Low-rank DCNv2 cross: x0 * (x @ down_proj_kernel @ kernel + bias)
    + x (glorot-uniform kernels, zero bias, f32 parameters). The JAX
    layer's full-rank form and its diag_scale and pre_activation options
    are not ported yet."""

    def __init__(
        self,
        dim: int,
        *,
        projection_dim: int,
        generator: torch.Generator | None = None,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        kinit = initializers.GlorotUniform()
        f32 = torch.float32
        self.down_proj_kernel = nn.Parameter(
            kinit((dim, projection_dim), f32, device, generator)
        )
        self.kernel = nn.Parameter(
            kinit((projection_dim, dim), f32, device, generator)
        )
        self.bias = nn.Parameter(
            initializers.Zeros()((dim,), f32, device, generator)
        )
        self.dim = dim
        self.projection_dim = projection_dim
        self.compute_dtype = _dtype(compute_dtype)
        # Cast `out` before the x0 * out + x combine so a bf16 residual
        # stream stays bf16.
        self.output_dtype = _dtype(output_dtype)

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
        out = self._matmul(x, self.down_proj_kernel)
        out = self._matmul(out, self.kernel) + self.bias
        if self.output_dtype is not None:
            out = out.to(self.output_dtype)
        return x0 * out + x
