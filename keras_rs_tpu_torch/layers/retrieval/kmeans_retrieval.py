"""Approximate MIPS retrieval: a k-means inverted file, IVF (counterpart
of keras_rs_tpu/layers/retrieval/kmeans_retrieval.py).

Candidates are partitioned by k-means (Lloyd iterations on the device),
stored as a padded [num_clusters, capacity, dim] tensor; a query scores
the centroids, picks `num_probes` clusters, gathers only their
candidates and scores them exactly. With `quantize="int8"` the index
holds per-candidate symmetric int8 rows and an exact f32 re-scoring of
the best `reorder_k` (ScaNN's reorder stage) gives the final top-k.

As in the reference, the gather `cluster_candidates[probe]` materializes
[B, num_probes, capacity, dim], and the capacity is the largest
cluster's size; the index build groups the candidates with numpy on the
host. The initial centroids are drawn from a `torch.Generator` seeded
with `seed`, where the reference draws from `jax.random.key(seed)`: the
two pick different candidates, so an index built here differs from the
reference's unless both start from the same centroids (`lloyd`) or the
reference's index is installed (`convert.load_kmeans_index`).
Nearest-centroid assignment takes the first minimum on ties, as
`jnp.argmin` does. Scores are f32 products (TF32 left off, PyTorch's
default).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.layers.retrieval.retrieval import Retrieval
from keras_rs_tpu_torch.ops.topk import top_k
from keras_rs_tpu_torch.utils.device import resolve_device

NEG_INF = float(np.finfo(np.float32).min / 2)

#: Rows per chunk of the assignment: the [N, K] distance matrix never
#: exists, only [chunk, K].
_KMEANS_CHUNK = 65536


def _distance_argmin(xb: torch.Tensor, centroids: torch.Tensor,
                     c_norm: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row of `xb` by ||c||^2 - 2 x.c (the
    reference's form, without the constant ||x||^2)."""
    return torch.argmin(-2.0 * torch.matmul(xb, centroids.T) + c_norm,
                        dim=1)


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment [N] (int64), chunked."""
    c_norm = torch.sum(centroids**2, dim=1)[None, :]
    return torch.cat([
        _distance_argmin(x[s : s + _KMEANS_CHUNK], centroids, c_norm)
        for s in range(0, x.shape[0], _KMEANS_CHUNK)
    ])


def lloyd(x: torch.Tensor, centroids: torch.Tensor,
          iterations: int) -> torch.Tensor:
    """`iterations` Lloyd steps from `centroids` [K, dim]. The per-cluster
    sums are `index_add_` over chunks (on CUDA, atomics: the last bits
    depend on the order); an empty cluster keeps its centroid."""
    num_clusters = centroids.shape[0]
    for _ in range(iterations):
        c_norm = torch.sum(centroids**2, dim=1)[None, :]
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(num_clusters, dtype=torch.float32,
                             device=x.device)
        for s in range(0, x.shape[0], _KMEANS_CHUNK):
            xb = x[s : s + _KMEANS_CHUNK]
            a = _distance_argmin(xb, centroids, c_norm)
            sums.index_add_(0, a, xb)
            counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids


def kmeans(x: torch.Tensor, num_clusters: int, *,
           generator: torch.Generator | None = None,
           iterations: int = 10) -> torch.Tensor:
    """Lloyd's k-means: [num_clusters, dim] centroids, started from
    `num_clusters` rows of `x` drawn with `generator` (without
    replacement unless num_clusters > N)."""
    n = x.shape[0]
    if num_clusters > n:
        init = torch.randint(n, (num_clusters,), generator=generator,
                             device=x.device)
    else:
        init = torch.randperm(n, generator=generator,
                              device=x.device)[:num_clusters]
    return lloyd(x, x[init], iterations)


@export("keras_rs_tpu_torch.layers.KMeansRetrieval")
class KMeansRetrieval(Retrieval):
    """IVF approximate top-k retrieval.

    Args:
        num_clusters: k-means partitions (default ~sqrt(N) at index time).
        num_probes: clusters searched per query; the recall/latency knob.
        quantize: None (exact f32 in-cluster scoring) or "int8"
            (per-candidate symmetric int8, 4x smaller index).
        reorder_k: with quantize, re-score this many int8-stage winners
            exactly against the f32 vectors (default 4 * k).
        device: where the index lives (default cuda:0).
    """

    def __init__(
        self,
        candidate_embeddings: torch.Tensor | None = None,
        candidate_ids: torch.Tensor | None = None,
        k: int = 10,
        return_scores: bool = True,
        num_clusters: int | None = None,
        num_probes: int = 4,
        kmeans_iterations: int = 10,
        quantize: str | None = None,
        reorder_k: int | None = None,
        seed: int = 0,
        name: str | None = None,
        device: Any = None,
    ) -> None:
        super().__init__(k=k, return_scores=return_scores, name=name)
        if quantize not in (None, "int8"):
            raise ValueError(f"Unsupported quantize mode: {quantize!r}")
        self.num_clusters = num_clusters
        self.num_probes = num_probes
        self.kmeans_iterations = kmeans_iterations
        self.quantize = quantize
        self.reorder_k = reorder_k
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids = None
        self.cluster_candidates = None
        self.cluster_ids = None
        self.cluster_valid = None
        self.cluster_scales = None
        self.cluster_pos = None
        self.flat_candidates = None
        if candidate_embeddings is not None:
            self.update_candidates(candidate_embeddings, candidate_ids)

    def update_candidates(self, candidate_embeddings: torch.Tensor,
                          candidate_ids: torch.Tensor | None = None) -> None:
        """Builds the index: k-means and the assignment on the device,
        the grouping into the padded cluster tensor on the host."""
        candidate_embeddings = torch.as_tensor(
            candidate_embeddings, device=self.device).to(torch.float32)
        self._validate_candidates(candidate_embeddings, candidate_ids)
        n, dim = candidate_embeddings.shape
        num_clusters = self.num_clusters or max(1, int(np.sqrt(n)))
        generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        centroids = kmeans(candidate_embeddings, num_clusters,
                           generator=generator,
                           iterations=self.kmeans_iterations)
        assign = assign_clusters(candidate_embeddings, centroids).cpu(
        ).numpy()
        counts = np.bincount(assign, minlength=num_clusters)
        capacity = int(counts.max())
        ids = (np.asarray(torch.as_tensor(candidate_ids).cpu())
               if candidate_ids is not None else np.arange(n))
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        within = np.arange(n) - np.searchsorted(sorted_assign, sorted_assign)
        grouped = np.zeros((num_clusters, capacity, dim), np.float32)
        grouped[sorted_assign, within] = candidate_embeddings.cpu().numpy(
        )[order]
        grouped_ids = np.zeros((num_clusters, capacity), np.int64)
        grouped_ids[sorted_assign, within] = ids[order]
        valid = np.zeros((num_clusters, capacity), bool)
        valid[sorted_assign, within] = True
        index = dict(centroids=centroids, cluster_ids=grouped_ids,
                     cluster_valid=valid)
        if self.quantize == "int8":
            # Per-candidate symmetric int8: v ~= q * scale. The f32
            # vectors stay for the exact reorder stage.
            absmax = np.abs(grouped).max(axis=2, keepdims=True)
            scales = (absmax / 127.0).astype(np.float32)
            q = np.where(
                scales > 0, np.round(grouped / np.maximum(scales, 1e-30)),
                0.0,
            ).astype(np.int8)
            grouped_pos = np.zeros((num_clusters, capacity), np.int64)
            grouped_pos[sorted_assign, within] = order
            index.update(cluster_candidates=q, cluster_scales=scales[..., 0],
                         cluster_pos=grouped_pos,
                         flat_candidates=candidate_embeddings)
        else:
            index.update(cluster_candidates=grouped)
        self.set_index(**index)

    def set_index(
        self,
        centroids: Any,
        cluster_candidates: Any,
        cluster_ids: Any,
        cluster_valid: Any,
        cluster_scales: Any = None,
        cluster_pos: Any = None,
        flat_candidates: Any = None,
    ) -> None:
        """Installs an index (arrays or tensors) on the layer's device:
        f32 [K, cap, dim] candidates, or int8 candidates with their
        [K, cap] scales, [K, cap] positions into the [N, dim] f32
        `flat_candidates`."""
        int8 = self.quantize == "int8"
        if any((a is None) == int8
               for a in (cluster_scales, cluster_pos, flat_candidates)):
            raise ValueError(
                "cluster_scales, cluster_pos and flat_candidates come with "
                "quantize='int8' and only with it."
            )

        def put(a: Any, dtype: torch.dtype) -> torch.Tensor:
            return torch.as_tensor(a).to(self.device, dtype)

        self.centroids = put(centroids, torch.float32)
        self.cluster_candidates = put(
            cluster_candidates, torch.int8 if int8 else torch.float32)
        self.cluster_ids = put(cluster_ids, torch.int64)
        self.cluster_valid = put(cluster_valid, torch.bool)
        self.cluster_scales = None if not int8 else put(cluster_scales,
                                                        torch.float32)
        self.cluster_pos = None if not int8 else put(cluster_pos,
                                                     torch.int64)
        self.flat_candidates = None if not int8 else put(flat_candidates,
                                                         torch.float32)

    def forward(self, inputs: torch.Tensor) -> Any:
        if self.centroids is None:
            raise ValueError(
                "No candidates. Call `update_candidates` first."
            )
        num_probes = min(self.num_probes, self.centroids.shape[0])
        # Stage 1: route to clusters by centroid dot product.
        _, probe = top_k(self.compute_score(inputs, self.centroids),
                         num_probes)  # [B, P]
        # Stage 2: scores within the probed clusters (f32, or int8).
        cands = self.cluster_candidates[probe]  # [B, P, cap, D]
        ids = self.cluster_ids[probe]  # [B, P, cap]
        valid = self.cluster_valid[probe]
        B = inputs.shape[0]
        if self.quantize == "int8":
            scores = torch.einsum(
                "bd,bpcd->bpc", inputs.float(), cands.float()
            ) * self.cluster_scales[probe]
        else:
            scores = torch.einsum("bd,bpcd->bpc", inputs, cands)
        scores = torch.where(valid, scores, NEG_INF)
        flat_scores = scores.reshape(B, -1)
        flat_ids = ids.reshape(B, -1)

        if self.quantize == "int8":
            # Stage 3 (ScaNN's reorder): exact f32 re-scoring of the
            # quantized stage's best reorder_k candidates.
            flat_pos = self.cluster_pos[probe].reshape(B, -1)
            rk = min(self.reorder_k or 4 * self.k, flat_scores.shape[1])
            _, r_idx = top_k(flat_scores, rk)
            r_pos = flat_pos.gather(1, r_idx)
            r_ids = flat_ids.gather(1, r_idx)
            r_valid = valid.reshape(B, -1).gather(1, r_idx)
            exact = torch.einsum("bd,brd->br", inputs,
                                 self.flat_candidates[r_pos])
            exact = torch.where(r_valid, exact, NEG_INF)
            top_scores, top_idx = top_k(exact, min(self.k, rk))
            top_ids = r_ids.gather(1, top_idx)
        else:
            top_scores, top_idx = top_k(
                flat_scores, min(self.k, flat_scores.shape[1]))
            top_ids = flat_ids.gather(1, top_idx)
        if self.return_scores:
            return top_scores, top_ids
        return top_ids

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update({
            "num_clusters": self.num_clusters,
            "num_probes": self.num_probes,
            "kmeans_iterations": self.kmeans_iterations,
            "quantize": self.quantize,
            "reorder_k": self.reorder_k,
            "seed": self.seed,
        })
        return config
