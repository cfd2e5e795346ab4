"""SASRec: self-attentive sequential recommendation (counterpart of
keras_rs_tpu/models/sasrec.py).

Tied item embedding + learned position embedding + N pre-norm causal
transformer blocks, trained with the contrastive BCE on aligned
positive/negative next-item sequences (`sasrec_loss`) and served by
top-k retrieval over the item table (`make_retrieval`).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.layers.attention import (
    Embedding,
    LayerNorm,
    PositionEmbedding,
    TransformerBlock,
)
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)
from keras_rs_tpu_torch.utils.device import resolve_device


class SASRec(nn.Module):
    def __init__(
        self,
        vocabulary_size: int,
        num_layers: int = 2,
        num_heads: int = 1,
        hidden_dim: int = 50,
        mlp_dim: int | None = None,
        max_sequence_length: int = 200,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        # Row 0 is the padding id.
        self.item_embedding = Embedding(
            vocabulary_size + 1, hidden_dim, generator=generator,
            embeddings_initializer="glorot_uniform", device=device,
        )
        self.position_embedding = PositionEmbedding(
            max_sequence_length, hidden_dim, generator=generator,
            device=device,
        )
        self.blocks = nn.ModuleList(
            TransformerBlock(
                hidden_dim, num_heads, mlp_dim or hidden_dim,
                generator=generator, device=device,
            )
            for _ in range(num_layers)
        )
        self.final_norm = LayerNorm(hidden_dim, device=device)
        self.vocabulary_size = vocabulary_size
        self.hidden_dim = hidden_dim
        self.max_sequence_length = max_sequence_length
        # Embedding scale, like the reference (sqrt(d) * E).
        self.scale = float(hidden_dim) ** 0.5

    def encode(self, item_ids: torch.Tensor) -> torch.Tensor:
        """item_ids: [B, T] (0 = padding) -> [B, T, D] states. The states
        of padded positions are zeroed after every block."""
        padding_mask = (item_ids != 0).to(torch.float32)
        x = self.item_embedding(item_ids) * self.scale
        x = x + self.position_embedding(x)
        x = x * padding_mask[..., None]
        for block in self.blocks:
            x = block(x, padding_mask=padding_mask)
            x = x * padding_mask[..., None]
        return self.final_norm(x)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        """[B, D] user representation: the state at position
        max(sum(item_ids != 0) - 1, 0), as in the JAX package (the last
        non-padding state of a right-padded row)."""
        states = self.encode(item_ids)
        last = ((item_ids != 0).sum(dim=1) - 1).clamp(min=0)
        return states[torch.arange(states.shape[0], device=states.device),
                      last]

    def score_items(self, user_repr: torch.Tensor,
                    item_ids: torch.Tensor) -> torch.Tensor:
        emb = self.item_embedding(item_ids)
        return (user_repr[:, None, :] * emb).sum(dim=-1)

    def make_retrieval(self, k: int = 10) -> BruteForceRetrieval:
        """Top-k over the whole item table (row 0, the padding id,
        included, as in the JAX package). The candidates share the
        table's storage."""
        return BruteForceRetrieval(
            self.item_embedding.embeddings.detach(), k=k
        )


def sasrec_loss(model: SASRec, batch: dict) -> torch.Tensor:
    """Contrastive BCE on aligned positive/negative next-item sequences.

    batch: item_history [B, T], positive_sequence [B, T],
    negative_sequence [B, T] (integer tensors on the model's device);
    positions whose positive is 0 are masked out.
    """
    states = model.encode(batch["item_history"])
    pos = model.item_embedding(batch["positive_sequence"])
    neg = model.item_embedding(batch["negative_sequence"])
    pos_logits = (states * pos).sum(dim=-1)
    neg_logits = (states * neg).sum(dim=-1)
    mask = (batch["positive_sequence"] != 0).to(torch.float32)

    def bce(logits, labels):
        return (torch.clamp(logits, min=0.0) - logits * labels
                + torch.log1p(torch.exp(-torch.abs(logits))))

    losses = bce(pos_logits, 1.0) + bce(neg_logits, 0.0)
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
