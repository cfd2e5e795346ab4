"""Exact top-k with the JAX package's tie order, and streaming top-k MIPS
(counterpart of keras_rs_tpu/ops/topk.py).

`lax.top_k` returns equal scores lowest index first; `torch.topk` does
not promise an order among ties. `top_k` here sorts stably on the
descending score, so ties keep their index order. `chunked_topk_mips`
streams candidates in [chunk] blocks, carrying a running [B, k] top-k
merged with each chunk's own: the [B, N] score matrix never exists, and
the result equals `top_k(queries @ candidates.T, k)`, ties included,
because the carry (lower indices) comes before the chunk in every
stable merge. The JAX package's approximate mode (`recall_target`,
`lax.approx_max_k`) is not ported.
"""

from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, in
    (score descending, index ascending) order, like `lax.top_k`."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def chunked_topk_mips(
    queries: torch.Tensor,  # [B, D]
    candidates: torch.Tensor,  # [N, D]
    k: int,
    chunk_size: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact streaming top-k dot-product search: (scores f32, idx int64),
    each [B, k]."""
    N = candidates.shape[0]
    if k > N:
        raise ValueError(f"k={k} > num candidates {N}")
    chunk = max(chunk_size, k)
    best_s = best_i = None
    for start in range(0, N, chunk):
        block = candidates[start : start + chunk]
        scores = torch.matmul(queries.float(), block.float().T)
        s, i = top_k(scores, min(k, block.shape[0]))
        i = i + start
        if best_s is None:
            best_s, best_i = s, i
            continue
        merged_s, pos = top_k(torch.cat([best_s, s], dim=1), k)
        best_i = torch.cat([best_i, i], dim=1).gather(1, pos)
        best_s = merged_s
    return best_s, best_i
