"""Exact brute-force retrieval with the candidates row-sharded over the
ranks of a mesh axis (counterpart of
keras_rs_tpu/parallel/sharded_retrieval.py).

Each rank holds one block of rows_per_shard = ceil(N / D) candidates
(block s holds global rows s * rows_per_shard + r; the last block is
padded), scores it with one [B, dim] x [dim, rows_per_shard] product,
masks the padding rows (global row >= N) to -inf and keeps its top
min(k, rows_per_shard). The D blocks of winners are all-gathered (k per
shard cross, not N) and merged shard-major, as the JAX package merges
them ([D, B, k] -> [B, D * k], then a top-k), so ties resolve the same
way: by score, then by shard, then by row. Above
BruteForceRetrieval.DIRECT_MAX_CANDIDATES rows per shard, the block is
scored in streamed chunks (ops/topk.chunked_topk_mips), which gives the
same winners without the [B, rows_per_shard] scores.
"""

from __future__ import annotations

from typing import Any

import torch

from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
    Retrieval,
)
from keras_rs_tpu_torch.ops.topk import chunked_topk_mips, top_k
from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.parallel import mesh as mesh_lib


class ShardedBruteForceRetrieval(Retrieval):
    """Exact top-k MIPS with the candidates row-sharded over a mesh axis.

    Every rank passes the same global candidates (and ids) and keeps its
    block; every rank calls the layer with the same queries (a
    collective) and gets the global top-k. The candidates are
    non-trainable state and not serialized, as in the JAX package.
    """

    def __init__(
        self,
        candidate_embeddings: Any = None,
        candidate_ids: Any = None,
        k: int = 10,
        return_scores: bool = True,
        *,
        mesh: mesh_lib.Mesh | None = None,
        axis_name: str = mesh_lib.DATA_AXIS,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        super().__init__(k=k, return_scores=return_scores, name=name)
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.create_mesh(device, axis_name))
        self.axis_name = axis_name
        self.num_shards = mesh_lib.axis_size(self.mesh, axis_name)
        self.shard = self.mesh.index(axis_name)
        self._group = self.mesh.group(axis_name)
        self.num_candidates = 0
        self.rows_per_shard = 0
        #: This rank's block of candidates [rows_per_shard, dim].
        self.candidate_embeddings = None
        #: The global ids [N] (on every rank), or None.
        self.candidate_ids = None
        if candidate_embeddings is None:
            if candidate_ids is not None:
                raise ValueError(
                    "You cannot provide `candidate_ids` without providing "
                    "`candidate_embeddings`."
                )
        else:
            self.update_candidates(candidate_embeddings, candidate_ids)

    def update_candidates(self, candidate_embeddings: Any,
                          candidate_ids: Any = None) -> None:
        """Keeps this rank's block of the global [N, dim] candidates (a
        copy on the mesh's device; rows past N are zero padding)."""
        device = self.mesh.device
        emb = torch.as_tensor(candidate_embeddings)
        ids = None if candidate_ids is None else torch.as_tensor(
            candidate_ids).to(device, torch.int32)
        self._validate_candidates(emb, ids)
        if self.candidate_embeddings is not None and (
                (self.candidate_ids is None) != (ids is None)):
            raise ValueError(
                "Presence of `candidate_ids` must be consistent across "
                "`update_candidates` calls."
            )
        n, dim = emb.shape
        rows = -(-n // self.num_shards)
        lo = min(self.shard * rows, n)
        hi = min(lo + rows, n)
        block = torch.zeros((rows, dim), dtype=emb.dtype, device=device)
        block[: hi - lo] = emb[lo:hi].to(device)
        self.num_candidates = n
        self.rows_per_shard = rows
        self.candidate_embeddings = block
        self.candidate_ids = ids

    def _local_top_k(self, queries: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """This shard's (scores [B, kk], global rows [B, kk]),
        kk = min(k, rows_per_shard), padding rows at -inf."""
        rows = self.rows_per_shard
        kk = min(self.k, rows)
        first = self.shard * rows
        valid = max(0, min(rows, self.num_candidates - first))
        block = self.candidate_embeddings
        if rows > BruteForceRetrieval.DIRECT_MAX_CANDIDATES and valid >= kk:
            # The padding rows (all at the end) would lose to kk valid
            # ones: stream the valid rows alone.
            scores, idx = chunked_topk_mips(queries, block[:valid], kk)
        else:
            scores = torch.matmul(queries, block.T).float()
            live = torch.arange(rows, device=block.device) < valid
            scores = torch.where(live[None, :], scores,
                                 torch.full_like(scores, float("-inf")))
            scores, idx = top_k(scores, kk)
        return scores, idx + first

    def forward(self, inputs: torch.Tensor):
        """(top scores [B, k], top global rows or ids [B, k]), or the
        rows / ids alone when return_scores is False."""
        if self.candidate_embeddings is None:
            raise ValueError(
                "No candidates. Call `update_candidates` first.")
        queries = inputs.to(self.candidate_embeddings.device)
        scores, rows = self._local_top_k(queries)
        b, kk = scores.shape
        D = self.num_shards
        all_s = collectives.all_gather(scores, self._group).view(D, b, kk)
        all_g = collectives.all_gather(rows, self._group).view(D, b, kk)
        flat_s = all_s.transpose(0, 1).reshape(b, -1)
        flat_g = all_g.transpose(0, 1).reshape(b, -1)
        top_s, top_i = top_k(flat_s, self.k)
        top_g = torch.gather(flat_g, 1, top_i)
        if self.candidate_ids is not None:
            top_g = self.candidate_ids[top_g]
        if self.return_scores:
            return top_s, top_g
        return top_g

    def get_config(self) -> dict[str, Any]:
        return {**super().get_config(), "axis_name": self.axis_name}
