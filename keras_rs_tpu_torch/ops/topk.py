"""Exact top-k with the JAX package's tie order, and streaming top-k MIPS
(counterpart of keras_rs_tpu/ops/topk.py).

`lax.top_k` returns equal scores lowest index first; `torch.topk` does
not promise an order among ties. `top_k` here sorts stably on the
descending score, so ties keep their index order. `chunked_topk_mips`
streams candidates in [chunk] blocks, carrying a running [B, k] top-k
merged with each chunk's own: the [B, N] score matrix never exists, and
the result equals `top_k(queries @ candidates.T, k)`, ties included,
because the carry (lower indices) comes before the chunk in every
stable merge.

The scores are f32 products. This module leaves
`torch.backends.cuda.matmul.allow_tf32` as PyTorch sets it (off): a TF32
product would reorder near-tied candidates.
"""

from __future__ import annotations

import torch

from keras_rs_tpu_torch.utils.shape_utils import round_up


_INT_OF_FLOAT = {torch.float64: torch.int64, torch.float32: torch.int32,
                 torch.float16: torch.int16, torch.bfloat16: torch.int16}


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, in
    (score descending, index ascending) order, like `lax.top_k`, which
    also puts +0.0 before -0.0: a float sort holds them equal, so floats
    are sorted by the integer of their bits that orders as the value
    does, -0.0 just below +0.0."""
    int_dtype = _INT_OF_FLOAT.get(scores.dtype)
    if int_dtype is None:
        keys = scores
    else:
        bits = scores.view(int_dtype)
        sign = torch.iinfo(int_dtype).bits - 1
        # Negative floats: flip the magnitude bits, so a larger magnitude
        # gives a smaller integer.
        keys = bits ^ ((bits >> sign) & ((1 << sign) - 1))
    _, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return scores.gather(-1, idx), idx


def chunked_topk_mips(
    queries: torch.Tensor,  # [B, D]
    candidates: torch.Tensor,  # [N, D]
    k: int,
    chunk_size: int = 65536,
    recall_target: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k dot-product search: (scores f32, idx int64),
    each [B, k].

    The chunks are the reference's: max(chunk_size, k), at most N, both
    rounded up to a multiple of 128. `recall_target` (the reference's
    approximate mode: overall recall >= roughly recall_target, from
    `lax.approx_max_k` per chunk, a TPU operation) is accepted and every
    chunk is selected exactly, which meets that contract: the result is
    the exact top-k whatever its value."""
    del recall_target  # exact selection meets any recall target
    N = candidates.shape[0]
    if k > N:
        raise ValueError(f"k={k} > num candidates {N}")
    chunk = round_up(min(max(chunk_size, k), round_up(N, 128)), 128)
    q = queries.float()
    neg = torch.finfo(torch.float32).min
    best_s = best_i = None
    for start in range(0, N, chunk):
        block = candidates[start : start + chunk].float()
        n = block.shape[0]
        if n < chunk:
            # The reference's padding: every product has the chunk's
            # width (a narrower one may round differently), and the
            # padded columns are masked out of the selection.
            block = torch.cat([block, block.new_zeros(chunk - n,
                                                      block.shape[1])])
        scores = torch.matmul(q, block.T)
        if n < chunk:
            scores[:, n:] = neg
        s, i = top_k(scores, k)
        i = i + start
        if best_s is None:
            best_s, best_i = s, i
            continue
        merged_s, pos = top_k(torch.cat([best_s, s], dim=1), k)
        best_i = torch.cat([best_i, i], dim=1).gather(1, pos)
        best_s = merged_s
    return best_s, best_i
