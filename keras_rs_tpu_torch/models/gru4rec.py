"""GRU4Rec sequential retrieval model (counterpart of
keras_rs_tpu/models/gru4rec.py).

An item embedding and a GRU form the query tower over a history of item
ids (0 = padding, masked out of the recurrence); a second item embedding
is the candidate tower. Trained with the in-batch softmax
(`gru4rec_loss`) and served by brute-force top-k over the candidate
table (`make_retrieval`).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.layers.attention import Embedding
from keras_rs_tpu_torch.layers.recurrent import GRU
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)
from keras_rs_tpu_torch.utils.device import resolve_device


class GRU4Rec(nn.Module):
    def __init__(
        self,
        num_items: int,
        embedding_dim: int = 128,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        # num_items + 1 rows: id 0 is the padding id.
        self.query_embedding = Embedding(
            num_items + 1, embedding_dim, generator=generator, device=device)
        self.gru = GRU(embedding_dim, embedding_dim, generator=generator,
                       device=device)
        self.candidate_embedding = Embedding(
            num_items + 1, embedding_dim, generator=generator, device=device)
        self.num_items = num_items
        self.embedding_dim = embedding_dim

    def query_tower(self, item_history: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
        """item_history: [B, T] item ids (0 = padding) -> [B, dim]; the
        mask defaults to ids != 0."""
        if mask is None:
            mask = (item_history != 0).to(torch.float32)
        return self.gru(self.query_embedding(item_history), mask=mask)

    def forward(self, item_history: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.query_tower(item_history, mask)

    def make_retrieval(self, k: int = 10) -> BruteForceRetrieval:
        """Top-k ids over the whole candidate table (row 0, the padding
        id, included, as in the JAX package); shares the table's
        storage."""
        return BruteForceRetrieval(
            self.candidate_embedding.embeddings.detach(), k=k,
            return_scores=False,
        )


def gru4rec_loss(model: GRU4Rec, batch: dict) -> torch.Tensor:
    """In-batch softmax cross-entropy with identity labels: history i's
    positive is target i, every other target of the batch a negative.
    batch: item_history [B, T], target_item [B]."""
    q = model.query_tower(batch["item_history"])
    c = model.candidate_embedding(batch["target_item"])
    logprobs = torch.log_softmax(torch.matmul(q, c.T), dim=-1)
    return -logprobs.diagonal().mean()
