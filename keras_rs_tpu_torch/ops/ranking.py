"""Ranking math: sorting by scores, list weights, DCG (counterpart of
keras_rs_tpu/ops/ranking.py).

Random tie-breaking draws from a `torch.Generator` where the reference
takes a `jax.random` key: the two give different permutations from the
same seed, so only results that do not depend on the tie order can
agree. Sorting is ops/topk.py's stable top-k (`lax.top_k`'s order) and
`torch.argsort(stable=True)`.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from keras_rs_tpu_torch.ops.topk import top_k


def divide_no_nan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x / y, returning 0 where y == 0 (grad-safe)."""
    zero = y == 0
    safe_y = torch.where(zero, torch.ones_like(y), y)
    return torch.where(zero, torch.zeros_like(x * safe_y), x / safe_y)


def standardize_call_inputs_ranks(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    mask: torch.Tensor | None = None,
    check_y_true_rank: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None, bool]:
    """Checks ranks and shapes and upranks 1-D (unbatched) inputs to 2-D."""
    if check_y_true_rank and y_true.ndim not in (1, 2):
        raise ValueError(
            f"`y_true` must have rank 1 or 2, got rank {y_true.ndim}."
        )
    if y_pred.ndim not in (1, 2):
        raise ValueError(
            f"`y_pred` must have rank 1 or 2, got rank {y_pred.ndim}."
        )
    if y_true.shape != y_pred.shape:
        raise ValueError(
            "`y_true` and `y_pred` must have the same shape. Received: "
            f"{tuple(y_true.shape)} vs {tuple(y_pred.shape)}."
        )
    if mask is not None and mask.shape != y_true.shape:
        raise ValueError(
            "`mask` must have the same shape as `y_true`. Received: "
            f"{tuple(mask.shape)} vs {tuple(y_true.shape)}."
        )
    batched = y_true.ndim != 1
    if not batched:
        y_true = y_true[None, :]
        y_pred = y_pred[None, :]
        if mask is not None:
            mask = mask[None, :]
    return y_true, y_pred, mask, batched


def get_shuffled_indices(
    shape: Sequence[int],
    *,
    device: torch.device | str | None = None,
    mask: torch.Tensor | None = None,
    shuffle_ties: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-row permutation: random tie-break order, masked entries last."""
    if shuffle_ties:
        if generator is None:
            raise ValueError(
                "`generator` is required when `shuffle_ties=True`.")
        shuffle_values = torch.rand(tuple(shape), generator=generator,
                                    device=device)
    else:
        shuffle_values = torch.zeros(tuple(shape), device=device)
    if mask is not None:
        # Values are in [0, 1); +1 pushes masked entries after all unmasked.
        shuffle_values = torch.where(mask, shuffle_values,
                                     shuffle_values + 1.0)
    return torch.argsort(shuffle_values, dim=-1, stable=True)


def sort_by_scores(
    tensors_to_sort: Sequence[torch.Tensor],
    scores: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    k: int | None = None,
    shuffle_ties: bool = True,
    generator: torch.Generator | None = None,
) -> list[torch.Tensor]:
    """Each tensor of `tensors_to_sort` sorted by `scores`, descending,
    cut to the top `k` columns. Masked entries sort last; ties are broken
    randomly when `shuffle_ties` and a generator are given, else by
    position."""
    list_size = scores.shape[-1]
    k = list_size if k is None else min(k, list_size)
    do_shuffle = shuffle_ties and generator is not None
    shuffled_indices = None
    if do_shuffle or mask is not None:
        shuffled_indices = get_shuffled_indices(
            scores.shape, device=scores.device, mask=mask,
            shuffle_ties=do_shuffle, generator=generator,
        )
        scores = scores.gather(-1, shuffled_indices)
    _, indices = top_k(scores, k)
    if shuffled_indices is not None:
        indices = shuffled_indices.gather(-1, indices)
    return [t.gather(-1, indices) for t in tensors_to_sort]


def get_list_weights(weights: torch.Tensor,
                     relevance: torch.Tensor) -> torch.Tensor:
    """Per-list weights from item weights and relevance:
    sum(weights * relevance) / sum(relevance); lists with zero relevance
    but nonzero weights get the average computed weight (1.0 if no list
    has relevance); lists with zero weights get 0."""
    nonzero_weights = weights.sum(dim=1, keepdim=True) > 0.0
    per_list_relevance = relevance.sum(dim=1, keepdim=True)
    nonzero_relevance_cond = per_list_relevance > 0.0
    nonzero_relevance = torch.logical_and(
        nonzero_weights, nonzero_relevance_cond).to(weights.dtype)
    nonzero_relevance_count = nonzero_relevance.sum(dim=0, keepdim=True)

    numerator = (weights * relevance).sum(dim=1, keepdim=True)
    per_list_weights = divide_no_nan(numerator, per_list_relevance)
    sum_weights = per_list_weights.sum(dim=0, keepdim=True)

    avg_weight = torch.where(
        nonzero_relevance_count > 0.0,
        divide_no_nan(sum_weights, nonzero_relevance_count),
        torch.ones_like(sum_weights),
    )
    return torch.where(
        nonzero_weights,
        torch.where(nonzero_relevance_cond, per_list_weights, avg_weight),
        torch.zeros_like(per_list_weights),
    )


def default_gain_fn(label: torch.Tensor) -> torch.Tensor:
    return torch.pow(2.0, label) - 1.0


def default_rank_discount_fn(rank: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.log2(1.0 + rank)


def compute_dcg(
    y_true: torch.Tensor,
    sample_weight: torch.Tensor,
    gain_fn: Callable[[torch.Tensor], torch.Tensor] = default_gain_fn,
    rank_discount_fn: Callable[[torch.Tensor], torch.Tensor] = (
        default_rank_discount_fn),
) -> torch.Tensor:
    """Weighted discounted cumulative gain over already-sorted labels."""
    positions = torch.arange(1, y_true.shape[1] + 1, dtype=y_true.dtype,
                             device=y_true.device)
    gain = gain_fn(y_true)
    discount = rank_discount_fn(positions)
    return (sample_weight * gain * discount).sum(dim=1, keepdim=True)
