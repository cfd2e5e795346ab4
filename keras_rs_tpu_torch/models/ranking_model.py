"""Basic ranking model: two embeddings and an MLP rating regressor
(counterpart of keras_rs_tpu/models/ranking_model.py; the reference's
examples/basic_ranking.py: MLP (256, 64, 1), MSE loss)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.utils.device import resolve_device


class BasicRanking(nn.Module):
    def __init__(
        self,
        num_users: int,
        num_items: int,
        embedding_dim: int = 32,
        hidden_units: tuple[int, ...] = (256, 64, 1),
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.user_embedding = EmbedReduce(
            num_users, embedding_dim, generator=generator, device=device)
        self.item_embedding = EmbedReduce(
            num_items, embedding_dim, generator=generator, device=device)
        self.mlp = MLP(2 * embedding_dim, hidden_units, generator=generator,
                       device=device)

    def forward(self, user_ids: torch.Tensor,
                item_ids: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.user_embedding(user_ids),
                       self.item_embedding(item_ids)], dim=-1)
        return self.mlp(x)[..., 0]


def mse_loss(model: BasicRanking, batch: dict) -> torch.Tensor:
    pred = model(batch["user_id"], batch["item_id"])
    return torch.mean((pred - batch["rating"]) ** 2)
