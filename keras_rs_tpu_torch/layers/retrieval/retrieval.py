"""Retrieval base + exact brute-force top-k MIPS (counterpart of
keras_rs_tpu/layers/retrieval/retrieval.py).

Scoring is one (B, D) x (D, N) product followed by a top-k in the JAX
package's tie order (ops/topk.py). Above DIRECT_MAX_CANDIDATES, or with an
explicit chunk size, the chunked path streams the candidates instead of
forming the [B, N] scores; it scores by dot product, so a subclass that
overrides `compute_score` stays on the direct path under "auto" and raises
with an explicit chunk size. `recall_target` is accepted and the chunked
path selects exactly (ops/topk.py). The mesh-sharded variant is
parallel/sharded_retrieval.py.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.ops.topk import chunked_topk_mips, top_k


class Retrieval(nn.Module):
    """Base class for candidate retrieval layers."""

    def __init__(
        self,
        k: int = 10,
        return_scores: bool = True,
        name: str | None = None,
    ) -> None:
        super().__init__()
        if k < 1:
            raise ValueError(f"`k` must be a positive integer, got {k}.")
        self.k = k
        self.return_scores = return_scores
        self.name = name or type(self).__name__

    @staticmethod
    def _validate_candidates(
        candidate_embeddings: torch.Tensor,
        candidate_ids: torch.Tensor | None,
    ) -> None:
        if candidate_embeddings.ndim != 2:
            raise ValueError(
                "`candidate_embeddings` must have rank 2, got rank "
                f"{candidate_embeddings.ndim}."
            )
        if candidate_ids is not None and (
            candidate_ids.ndim != 1
            or candidate_ids.shape[0] != candidate_embeddings.shape[0]
        ):
            raise ValueError(
                "`candidate_ids` must be 1-D with one id per candidate. "
                f"Received {tuple(candidate_ids.shape)} vs "
                f"{tuple(candidate_embeddings.shape)}."
            )

    def compute_score(self, query_embedding: torch.Tensor,
                      candidate_embedding: torch.Tensor) -> torch.Tensor:
        """Dense dot-product scores: (B, D) @ (D, N)."""
        return torch.matmul(query_embedding, candidate_embedding.T)

    def update_candidates(self, candidate_embeddings: torch.Tensor,
                          candidate_ids: torch.Tensor | None = None) -> None:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        return {
            "k": self.k,
            "return_scores": self.return_scores,
            "name": self.name,
        }


@export("keras_rs_tpu_torch.layers.BruteForceRetrieval")
class BruteForceRetrieval(Retrieval):
    """Exact top-k retrieval by scoring all candidates (non-trainable
    state, not serialized)."""

    #: Above this candidate count "auto" takes the chunked path.
    DIRECT_MAX_CANDIDATES = 131072

    def __init__(
        self,
        candidate_embeddings: torch.Tensor | None = None,
        candidate_ids: torch.Tensor | None = None,
        k: int = 10,
        return_scores: bool = True,
        chunk_size: int | str | None = "auto",
        recall_target: float | None = None,
        name: str | None = None,
    ) -> None:
        super().__init__(k=k, return_scores=return_scores, name=name)
        self.chunk_size = chunk_size
        #: Passed to the chunked path, which meets it by exact selection.
        self.recall_target = recall_target
        self.candidate_embeddings = None
        self.candidate_ids = None
        if candidate_embeddings is None:
            if candidate_ids is not None:
                raise ValueError(
                    "You cannot provide `candidate_ids` without providing "
                    "`candidate_embeddings`."
                )
        else:
            self.update_candidates(candidate_embeddings, candidate_ids)

    def update_candidates(self, candidate_embeddings: torch.Tensor,
                          candidate_ids: torch.Tensor | None = None) -> None:
        self._validate_candidates(candidate_embeddings, candidate_ids)
        if self.candidate_embeddings is not None and (
            (self.candidate_ids is None) != (candidate_ids is None)
        ):
            raise ValueError(
                "Presence of `candidate_ids` must be consistent across "
                "`update_candidates` calls."
            )
        self.candidate_embeddings = candidate_embeddings
        self.candidate_ids = candidate_ids

    def forward(self, inputs: torch.Tensor):
        """(top scores [B, k], top indices or ids [B, k]), or the indices
        alone when return_scores is False."""
        if self.candidate_embeddings is None:
            raise ValueError(
                "No candidates. Call `update_candidates` first."
            )
        n = self.candidate_embeddings.shape[0]
        custom_score = (
            type(self).compute_score is not Retrieval.compute_score
        )
        use_chunked = self.chunk_size not in (None, 0) and (
            self.chunk_size != "auto"
            or (n > self.DIRECT_MAX_CANDIDATES and not custom_score)
        )
        if use_chunked and custom_score:
            raise ValueError(
                "Chunked retrieval assumes dot-product scoring; "
                f"{type(self).__name__} overrides compute_score. Pass "
                "chunk_size=None (or 'auto') to use the direct path."
            )
        if use_chunked:
            chunk = 65536 if self.chunk_size == "auto" else int(
                self.chunk_size)
            top_scores, top_idx = chunked_topk_mips(
                inputs, self.candidate_embeddings, self.k, chunk,
                recall_target=self.recall_target,
            )
        else:
            top_scores, top_idx = top_k(
                self.compute_score(inputs, self.candidate_embeddings),
                self.k,
            )
        if self.candidate_ids is not None:
            top_idx = self.candidate_ids[top_idx]
        if self.return_scores:
            return top_scores, top_idx
        return top_idx
