"""Two-tower retrieval model (counterpart of
keras_rs_tpu/models/two_tower.py).

A query tower and a candidate tower, each an `EmbedReduce` table with an
optional MLP head, whose dot product scores candidates; trained with the
in-batch softmax (over the global batch when data parallel over ranks)
and served by brute-force top-k over every candidate.
Parameter names follow the reference's attributes
(`query_embedding.embeddings`, `candidate_mlp.layers.0.kernel`, ...), so
its arrays load one to one through `convert.load_params`.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)
from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.utils.device import resolve_device


class TwoTower(nn.Module):
    """Embedding towers for (query, candidate) retrieval; with
    `tower_units`, an MLP head on each tower (the "deep recommender")."""

    def __init__(
        self,
        num_queries: int,
        num_candidates: int,
        embedding_dim: int,
        *,
        generator: torch.Generator | None = None,
        tower_units: tuple[int, ...] = (),
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.query_embedding = EmbedReduce(
            num_queries, embedding_dim, generator=generator, device=device)
        self.candidate_embedding = EmbedReduce(
            num_candidates, embedding_dim, generator=generator,
            device=device)
        self.query_mlp = self.candidate_mlp = None
        if tower_units:
            self.query_mlp = MLP(embedding_dim, tower_units,
                                 generator=generator, device=device)
            self.candidate_mlp = MLP(embedding_dim, tower_units,
                                     generator=generator, device=device)
        self.num_queries = num_queries
        self.num_candidates = num_candidates
        self.embedding_dim = embedding_dim

    def query_tower(self, query_ids: torch.Tensor) -> torch.Tensor:
        e = self.query_embedding(query_ids)
        return self.query_mlp(e) if self.query_mlp is not None else e

    def candidate_tower(self, candidate_ids: torch.Tensor) -> torch.Tensor:
        e = self.candidate_embedding(candidate_ids)
        return self.candidate_mlp(e) if self.candidate_mlp is not None else e

    def forward(self, query_ids: torch.Tensor,
                candidate_ids: torch.Tensor) -> torch.Tensor:
        """Per-pair scores: dot(query_emb, candidate_emb)."""
        q = self.query_tower(query_ids)
        c = self.candidate_tower(candidate_ids)
        return torch.sum(q * c, dim=-1)

    def in_batch_scores(self, query_ids: torch.Tensor,
                        candidate_ids: torch.Tensor) -> torch.Tensor:
        """(B, B) scores of each query against the batch's candidates."""
        q = self.query_tower(query_ids)
        c = self.candidate_tower(candidate_ids)
        return torch.matmul(q, c.T)

    @torch.no_grad()
    def make_retrieval(
        self, k: int = 10, candidate_ids: torch.Tensor | None = None
    ) -> BruteForceRetrieval:
        """A brute-force retrieval head over ALL candidates."""
        table = self.candidate_embedding.embeddings
        all_ids = torch.arange(self.num_candidates, device=table.device)
        candidates = self.candidate_tower(all_ids)
        return BruteForceRetrieval(candidates, candidate_ids, k=k)


def in_batch_softmax_loss(
    model: TwoTower,
    query_ids: torch.Tensor,
    candidate_ids: torch.Tensor,
    sampling_probability: torch.Tensor | None = None,
    mesh: Any = None,
) -> torch.Tensor:
    """In-batch sampled softmax, positives on the diagonal, with the logQ
    correction when the candidates' sampling probabilities are given.

    With a `mesh` of D > 1 ranks (data parallel, make_train_step(mesh=))
    the ids are this rank's b = B / D rows and the loss is the JAX
    step's over the global batch: every query scores against all B
    candidates (all-gathered, their gradients summed back into the
    owning rank), its positive at column rank * b + i, and the rank
    returns the mean over its queries, whose mean over the ranks
    (make_train_step's average) is the global mean."""
    axes = None if mesh is None else mesh.axis_names
    group = None if mesh is None else mesh.group(axes)
    q = model.query_tower(query_ids)
    c = collectives.all_gather_with_grad(
        model.candidate_tower(candidate_ids), group)
    scores = torch.matmul(q, c.T)
    if sampling_probability is not None:
        p = collectives.all_gather(sampling_probability.contiguous(), group)
        scores = scores - torch.log(torch.clamp(p, 1e-6, 1.0))
    b = q.shape[0]
    rows = torch.arange(b, device=q.device)
    first = 0 if mesh is None else mesh.index(axes) * b
    return -torch.log_softmax(scores, dim=-1)[rows, rows + first].mean()
