"""EmbedReduce: embedding lookup followed by a weighted combiner reduce.

Counterpart of keras_rs_tpu/layers/embedding/embed_reduce.py for padded
dense inputs: a (B, L) id matrix plus an optional (B, L) weight matrix
whose zeros mark padding. The table is an `nn.Parameter` with a dense
gradient (`F.embedding`'s backward), updated by the dense optimizer. Ragged and sparse inputs and
the int8 serving variant are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.utils.device import resolve_device

SUPPORTED_COMBINERS = ("mean", "sum", "sqrtn")


def _divide_no_nan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    safe = torch.where(y == 0, torch.ones_like(y), y)
    return torch.where(y == 0, torch.zeros_like(x), x / safe)


class EmbedReduce(nn.Module):
    """Embeds 1-D or 2-D integer inputs; reduces the list axis if present.

    Combiner semantics (as in the JAX package):
      * 1-D inputs: no reduction; "sum" still scales by weights, while
        "mean"/"sqrtn" ignore weights.
      * 2-D inputs: weighted sum over axis -2, divided by sum(weights)
        for "mean" or sqrt(sum(weights^2)) for "sqrtn".
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        generator: torch.Generator | None = None,
        embeddings_initializer: Any = "random_uniform",
        combiner: str = "mean",
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__()
        if combiner not in SUPPORTED_COMBINERS:
            raise ValueError(
                f"Invalid `combiner`: '{combiner}', use one of "
                f"{', '.join(SUPPORTED_COMBINERS)}."
            )
        device = resolve_device(device)
        self.embeddings = nn.Parameter(
            initializers.get(embeddings_initializer)(
                (input_dim, output_dim), torch.float32, device, generator
            )
        )
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.name = name or "embed_reduce"

    def forward(
        self, inputs: torch.Tensor, weights: torch.Tensor | None = None
    ) -> torch.Tensor:
        if inputs.ndim < 1:
            raise ValueError("`inputs` must have rank >= 1.")
        x = self._lookup(inputs)
        if inputs.ndim == 1:
            if weights is not None and self.combiner == "sum":
                x = x * weights.to(x.dtype)[:, None]
            return x
        if weights is None:
            x = x.sum(dim=-2)
            if self.combiner == "sum":
                return x
            weights = torch.ones(inputs.shape, dtype=x.dtype,
                                 device=x.device)
        else:
            weights = weights.to(x.dtype)
            if weights.shape != inputs.shape:
                raise ValueError(
                    f"`weights` shape {tuple(weights.shape)} must match "
                    f"`inputs` shape {tuple(inputs.shape)}."
                )
            x = (x * weights[..., None]).sum(dim=-2)
        if self.combiner == "mean":
            return _divide_no_nan(x, weights.sum(dim=-1)[..., None])
        if self.combiner == "sqrtn":
            return _divide_no_nan(
                x, torch.sqrt(torch.square(weights).sum(dim=-1))[..., None]
            )
        return x

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table by id, as the reference's `jnp.take` fetches
        them: a negative id counts from the end (-1 is the last row), and
        an id outside [-vocab, vocab) gives a row of NaN, on the CPU and
        on CUDA alike (no index error, no device-side assert)."""
        n = self.input_dim
        ids = torch.where(ids < 0, ids + n, ids)
        outside = (ids < 0) | (ids >= n)
        rows = F.embedding(torch.where(outside, 0, ids), self.embeddings)
        return torch.where(outside[..., None], torch.nan, rows)
