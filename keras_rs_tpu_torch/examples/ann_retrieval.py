"""Retrieval engine shoot-out: exact, streaming, approximate, sharded.

The port of examples/ann_retrieval.py: one candidate set (100,000 x 64
f32 gaussians, 256 queries, k = 10) through the whole retrieval
inventory:

  brute force        one [B, N] product + top-k (exact);
  chunked exact      the streaming top-k (ops/topk.py): exact without
                     the [B, N] scores;
  chunked approx     the same with recall_target=0.95 (met by exact
                     selection here);
  kmeans-IVF         k-means routing of each query to 32 of 316
                     clusters, scoring only those;
  IVF int8+reorder   the int8 cluster scan, then exact rescoring of the
                     top 4k;
  sharded exact xD   the candidates row-sharded over the ranks, k
                     winners per shard merged
                     (parallel/sharded_retrieval.py).

Each row gives the latency of one 256-query batch (host clock around
the call, the device synchronized, mean of 3 after a first call),
recall@10 against brute force, and the index bytes. Uniform gaussians
have no cluster structure, the hardest case for an IVF index. Under a
launcher every rank builds every engine and calls it (the sharded one
is a collective); rank 0 prints.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.ann_retrieval             # cuda:0
  torchrun --nproc_per_node 2 -m keras_rs_tpu_torch.examples.ann_retrieval \\
      --device cpu
On one card, two ranks need `--device cuda:0 --dist_backend gloo`.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch.layers.retrieval.kmeans_retrieval import (
    KMeansRetrieval,
)
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)
from keras_rs_tpu_torch.parallel import multihost
from keras_rs_tpu_torch.parallel.sharded_retrieval import (
    ShardedBruteForceRetrieval,
)


def timed(call: Callable, q: torch.Tensor, reps: int = 3):
    """(mean seconds per call after a first one, the last result)."""
    def sync() -> None:
        if q.device.type == "cuda":
            torch.cuda.synchronize(q.device)

    out = call(q)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call(q)
    sync()
    return (time.perf_counter() - t0) / reps, out


def main(num_candidates: int = 100_000, dim: int = 64,
         num_queries: int = 256, k: int = 10, device: Any = None,
         dist_backend: str | None = None) -> dict:
    """Runs the shoot-out; returns {engine: {"ms", "recall", "bytes",
    "ids"}}."""
    device = multihost.rank_device(device)
    started = not dist.is_initialized() and multihost.initialize(
        device, dist_backend)
    rng = np.random.default_rng(0)
    cand = torch.from_numpy(
        rng.normal(size=(num_candidates, dim)).astype(np.float32)).to(device)
    q = torch.from_numpy(
        rng.normal(size=(num_queries, dim)).astype(np.float32)).to(device)
    f32_bytes = num_candidates * dim * 4

    engines = {}
    bf = BruteForceRetrieval(cand, k=k, chunk_size=None)
    engines["brute force"] = (bf, f32_bytes)
    engines["chunked exact"] = (
        BruteForceRetrieval(cand, k=k, chunk_size=16384), f32_bytes)
    engines["chunked approx"] = (
        BruteForceRetrieval(cand, k=k, chunk_size=16384,
                            recall_target=0.95), f32_bytes)
    ann = KMeansRetrieval(cand, k=k, num_clusters=316, num_probes=32,
                          kmeans_iterations=5, device=device)
    engines["kmeans-IVF"] = (ann, _nbytes(ann.cluster_candidates))
    ann8 = KMeansRetrieval(cand, k=k, num_clusters=316, num_probes=32,
                           kmeans_iterations=5, quantize="int8",
                           reorder_k=4 * k, device=device)
    engines["IVF int8+reorder"] = (ann8, _nbytes(ann8.cluster_candidates))
    sh = ShardedBruteForceRetrieval(cand, k=k, device=device)
    # Global bytes; 1 / D of them on each rank.
    engines[f"sharded exact x{sh.num_shards}"] = (sh, f32_bytes)

    rank0 = multihost.process_index() == 0
    results: dict[str, dict] = {}
    exact_ids = None
    header = f"{'engine':18s}  latency    recall@{k}  index"
    if rank0:
        print(header)
        print("-" * len(header))
    for name, (engine, nbytes) in engines.items():
        with torch.no_grad():
            seconds, (_, ids) = timed(engine, q)
        ids = ids.cpu().numpy()
        if exact_ids is None:
            exact_ids = ids  # brute force runs first: the ground truth
        recall = float(np.mean([len(set(a) & set(e)) / k
                                for a, e in zip(ids, exact_ids)]))
        results[name] = {"ms": seconds * 1e3, "recall": recall,
                         "bytes": nbytes, "ids": ids}
        if rank0:
            print(f"{name:18s}  {seconds * 1e3:7.2f} ms   {recall:.3f}   "
                  f"{nbytes / 1e6:5.0f} MB")
    if started:
        dist.destroy_process_group()
    return results


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0, or "
                        "cuda:LOCAL_RANK under a launcher)")
    parser.add_argument("--dist_backend", default=None,
                        help="default nccl on CUDA, gloo on the CPU")
    parser.add_argument("--num_candidates", type=int, default=100_000)
    args = parser.parse_args()
    main(args.num_candidates, device=args.device,
         dist_backend=args.dist_backend)
