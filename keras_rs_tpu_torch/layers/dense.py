"""Dense / MLP building blocks (counterpart of keras_rs_tpu/layers/dense.py).

Layout: `kernel` keeps the JAX package's [in, out] layout (y = x @ kernel,
not nn.Linear's [out, in]), so parameters move between the packages
without a transpose.

Mixed precision follows the JAX package: with `compute_dtype` the
operands are cast (typically to bfloat16) and the product is cast back to
the parameter dtype before the bias; `output_dtype` casts the layer's
output (bf16-resident activations). One difference: jnp.matmul with
preferred_element_type=f32 keeps the f32 accumulator, while a bf16
torch.matmul rounds its result to bf16 before the cast back, so the bf16
paths of the two packages differ by that rounding.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.core import regularizers as reg_lib
from keras_rs_tpu_torch.utils.device import resolve_device


def _dtype(d: Any) -> torch.dtype | None:
    if d is None or isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(d))


def regularizers_of(**named: Any) -> dict[str, reg_lib.Regularizer]:
    """{attribute: Regularizer} of the given ones that are not None (the
    `_regularizers` dict core.regularizers.regularization_loss reads)."""
    regs = {attr: reg_lib.get(r) for attr, r in named.items()}
    return {attr: r for attr, r in regs.items() if r is not None}


class Dense(nn.Module):
    """y = activation(x @ kernel + bias), f32 parameters: the kernel from
    `kernel_initializer` (glorot-uniform), the bias from
    `bias_initializer` (zeros), or no bias with `use_bias=False` (then
    `bias` is None). Initializers are names or core.initializers
    objects. `kernel_regularizer` / `bias_regularizer` (names or
    core.regularizers objects) add their penalties to
    `regularization_loss`."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        generator: torch.Generator | None = None,
        use_bias: bool = True,
        activation: Callable[[torch.Tensor], torch.Tensor] | None = None,
        kernel_initializer: Any = "glorot_uniform",
        bias_initializer: Any = "zeros",
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self._regularizers = regularizers_of(
            kernel=kernel_regularizer,
            bias=bias_regularizer if use_bias else None)
        self.kernel = nn.Parameter(
            initializers.get(kernel_initializer)(
                (in_features, out_features), torch.float32, device, generator
            )
        )
        self.bias = (
            nn.Parameter(initializers.get(bias_initializer)(
                (out_features,), torch.float32, device, generator))
            if use_bias else None
        )
        self.activation = activation
        self.compute_dtype = _dtype(compute_dtype)
        self.output_dtype = _dtype(output_dtype)
        self.name = name or "dense"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            y = torch.matmul(
                x.to(self.compute_dtype), self.kernel.to(self.compute_dtype)
            ).to(self.kernel.dtype)
        else:
            y = torch.matmul(x, self.kernel)
        if self.bias is not None:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        if self.output_dtype is not None:
            y = y.to(self.output_dtype)
        return y


class MLP(nn.Module):
    """Stack of Dense layers, e.g. DLRM's bottom and top towers: each
    hidden layer takes `activation` (ReLU), the last one
    `final_activation` (none). Hidden outputs take `output_dtype`; the
    final output stays f32. The regularizers apply to every layer."""

    def __init__(
        self,
        in_features: int,
        units: Sequence[int],
        *,
        generator: torch.Generator | None = None,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        final_activation: (
            Callable[[torch.Tensor], torch.Tensor] | None) = None,
        kernel_regularizer: Any = None,
        bias_regularizer: Any = None,
        compute_dtype: Any = None,
        output_dtype: Any = None,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        layers = []
        prev = in_features
        for i, u in enumerate(units):
            last = i == len(units) - 1
            layers.append(
                Dense(
                    prev, u, generator=generator,
                    activation=final_activation if last else activation,
                    kernel_regularizer=kernel_regularizer,
                    bias_regularizer=bias_regularizer,
                    compute_dtype=compute_dtype,
                    output_dtype=None if last else output_dtype,
                    device=device,
                )
            )
            prev = u
        self.layers = nn.ModuleList(layers)
        self.name = name or "mlp"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
