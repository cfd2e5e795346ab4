"""DLRM DotInteraction layer (counterpart of
keras_rs_tpu/layers/feature_interaction/dot_interaction.py).

Stacks F features of width D into [B, F, F] pairwise dot products (one
batched product), then keeps the strict lower triangle (the diagonal
too with `self_interaction`): gathered into [B, F(F-1)/2] columns, or,
with `skip_gather`, masked and flattened to [B, F * F], which trades a
wider output for no gather.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from keras_rs_tpu_torch.core.serialization import export


@export("keras_rs_tpu_torch.layers.DotInteraction")
class DotInteraction(nn.Module):
    def __init__(
        self,
        self_interaction: bool = False,
        skip_gather: bool = False,
        name: str | None = None,
    ) -> None:
        super().__init__()
        self.self_interaction = self_interaction
        self.skip_gather = skip_gather
        self.name = name or "dot_interaction"
        # (num_features, device) -> the triangle's flat indices or mask,
        # built once on the device.
        self._triangles: dict[tuple[int, torch.device], torch.Tensor] = {}

    def _triangle(self, num_features: int,
                  device: torch.device) -> torch.Tensor:
        """The kept entries of the [F, F] products: a bool [F, F] mask
        (skip_gather) or the int64 row-major flat indices, row by row as
        np.tril_indices orders them."""
        key = (num_features, device)
        if key not in self._triangles:
            offset = 0 if self.self_interaction else -1
            if self.skip_gather:
                t = torch.ones((num_features, num_features), dtype=torch.bool,
                               device=device).tril(offset)
            else:
                rows, cols = torch.tril_indices(num_features, num_features,
                                                offset, device=device)
                t = rows * num_features + cols
            self._triangles[key] = t
        return self._triangles[key]

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        shape = inputs[0].shape
        for idx, t in enumerate(inputs):
            if t.ndim != 2:
                raise ValueError(
                    "All feature tensors inside `inputs` should have rank 2. "
                    f"Received rank {t.ndim} at index {idx}."
                )
            if t.shape != shape:
                raise ValueError(
                    "All feature tensors in `inputs` should have the same "
                    f"shape. Found {tuple(shape)} at index 0 and "
                    f"{tuple(t.shape)} at index {idx}."
                )
        features = torch.stack(list(inputs), dim=1)  # [B, F, D]
        batch_size, num_features, _ = features.shape
        interactions = torch.bmm(features, features.transpose(1, 2))
        tri = self._triangle(num_features, features.device)
        if self.skip_gather:
            out = interactions * tri.to(interactions.dtype)
            return out.reshape(batch_size, num_features * num_features)
        flat = interactions.reshape(batch_size, num_features * num_features)
        return flat.index_select(1, tri)

    def output_dim(self, num_features: int) -> int:
        if self.skip_gather:
            return num_features * num_features
        if self.self_interaction:
            return num_features * (num_features + 1) // 2
        return num_features * (num_features - 1) // 2

    def get_config(self) -> dict[str, Any]:
        return {
            "self_interaction": self.self_interaction,
            "skip_gather": self.skip_gather,
            "name": self.name,
        }
