"""GRU layer for sequential retrieval (counterpart of
keras_rs_tpu/layers/recurrent.py).

The input projections of all timesteps are one batched product; only
the small recurrent product runs inside the loop over T. Padded steps
(mask 0) carry the previous state exactly, for any mask (left padding,
right padding or holes).

Layout as in the JAX package, so `convert` copies without reordering:
`kernel` [input_dim, 3H] and `recurrent_kernel` [H, 3H] with the gates
split (z, r, h). torch.nn.GRU (cuDNN) orders its gates (r, z, n) and
takes no mask with holes, so it is not this layer.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.utils.device import resolve_device


class GRU(nn.Module):
    """Gated recurrent unit returning the final hidden state (Keras'
    reset_after=True form):

        z = sigmoid(x Wz + bz + h Uz + cz)
        r = sigmoid(x Wr + br + h Ur + cr)
        h~ = tanh(x Wh + bh + r * (h Uh + ch))
        h' = z * h + (1 - z) * h~

    Init: Glorot-uniform kernel, VarianceScaling(1, fan_in, normal)
    recurrent kernel, zero biases.
    """

    def __init__(
        self,
        input_dim: int,
        units: int,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        f32 = torch.float32
        self.kernel = nn.Parameter(initializers.GlorotUniform()(
            (input_dim, 3 * units), f32, device, generator))
        self.recurrent_kernel = nn.Parameter(initializers.VarianceScaling(
            1.0, "fan_in", "normal")((units, 3 * units), f32, device,
                                     generator))
        self.bias = nn.Parameter(torch.zeros(3 * units, device=device))
        self.recurrent_bias = nn.Parameter(
            torch.zeros(3 * units, device=device))
        self.units = units
        self.input_dim = input_dim
        self.name = name or "gru"

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, T, input_dim]; mask: [B, T], 1 for a real step. Returns
        the last hidden state [B, units]."""
        B, T, _ = x.shape
        H = self.units
        xz = (torch.matmul(x, self.kernel) + self.bias).transpose(0, 1)
        if mask is None:
            mask_t = torch.ones((T, B, 1), dtype=x.dtype, device=x.device)
        else:
            mask_t = mask.to(x.dtype).transpose(0, 1)[..., None]
        h = torch.zeros((B, H), dtype=x.dtype, device=x.device)
        for t in range(T):
            rec = torch.matmul(h, self.recurrent_kernel) + self.recurrent_bias
            xz_, xr_, xh_ = xz[t].split(H, dim=-1)
            rz_, rr_, rh_ = rec.split(H, dim=-1)
            z = torch.sigmoid(xz_ + rz_)
            r = torch.sigmoid(xr_ + rr_)
            h_tilde = torch.tanh(xh_ + r * rh_)
            new_h = z * h + (1.0 - z) * h_tilde
            m = mask_t[t]
            h = m * new_h + (1.0 - m) * h
        return h
