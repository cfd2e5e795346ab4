"""Pairwise comparisons for the ranking losses (counterpart of
keras_rs_tpu/ops/pairwise.py): the (batch, list, list) structures built
by broadcasting."""

from __future__ import annotations

from typing import Callable

import torch


def apply_pairwise_op(
    x: torch.Tensor,
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """op(x_i, x_j) for all (i, j) pairs along the last axis: (..., L, L)."""
    return op(x.unsqueeze(-1), x.unsqueeze(-2))


def pairwise_comparison(
    labels: torch.Tensor,
    logits: torch.Tensor,
    mask: torch.Tensor | None,
    logits_op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise label indicators and pairwise logit combinations:
    `pairwise_labels[b, i, j] = 1 if labels[b, i] > labels[b, j]` (and
    both valid under `mask`), `pairwise_logits[b, i, j] = op(s_i, s_j)`."""
    pairwise_labels_diff = apply_pairwise_op(labels, torch.subtract)
    pairwise_logits = apply_pairwise_op(logits, logits_op)
    pairwise_labels = (pairwise_labels_diff > 0).to(labels.dtype)
    if mask is not None:
        valid_pairs = apply_pairwise_op(mask, torch.logical_and)
        pairwise_labels = pairwise_labels * valid_pairs.to(
            pairwise_labels.dtype)
    return pairwise_labels, pairwise_logits
