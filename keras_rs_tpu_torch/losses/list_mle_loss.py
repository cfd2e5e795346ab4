"""ListMLE listwise ranking loss (counterpart of
keras_rs_tpu/losses/list_mle_loss.py).

Logits are sorted by label (stable, no tie shuffling) and scaled by the
temperature; the loss is the negative log-likelihood of that permutation,
each term normalized by a reversed cumulative sum of exp(logits), after
subtracting the list's maximum valid logit. Invalid entries (label < 0 or
masked) take -1e9 sentinels, exactly as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.losses.base import Loss, unpack_labels_and_mask
from keras_rs_tpu_torch.ops.ranking import (
    sort_by_scores,
    standardize_call_inputs_ranks,
)


@export("keras_rs_tpu_torch.losses.ListMLELoss")
class ListMLELoss(Loss):
    """loss = -sum_i log(exp(s_i) / sum_{j >= i} exp(s_j)), items ordered
    by descending true label; one loss per list."""

    def __init__(self, temperature: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if temperature <= 0.0:
            raise ValueError(
                "`temperature` should be a positive float. Received: "
                f"`temperature` = {temperature}."
            )
        self.temperature = temperature
        self.epsilon = 1e-10

    def compute_unreduced_loss(
        self,
        labels: torch.Tensor,
        logits: torch.Tensor,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = torch.logical_and(valid_mask, mask.to(torch.bool))
        num_valid = valid_mask.to(labels.dtype).sum(dim=1, keepdim=True)
        has_valid = num_valid > 0.0

        neg_inf = torch.full_like(labels, -1e9)
        labels_for_sorting = torch.where(valid_mask, labels, neg_inf)
        logits_masked = torch.where(valid_mask, logits,
                                    torch.full_like(logits, -1e9))
        sorted_logits, sorted_valid_mask = sort_by_scores(
            [logits_masked, valid_mask], scores=labels_for_sorting,
            mask=None, shuffle_ties=False,
        )
        sorted_logits = sorted_logits / self.temperature

        # Stabilize: subtract the per-list max over valid entries.
        sentinel = torch.full_like(sorted_logits, -1e9)
        valid_for_max = torch.where(sorted_valid_mask, sorted_logits,
                                    sentinel)
        raw_max = valid_for_max.amax(dim=1, keepdim=True)
        raw_max = torch.where(has_valid, raw_max, torch.zeros_like(raw_max))
        sorted_logits = sorted_logits - raw_max
        sorted_logits = torch.where(sorted_valid_mask, sorted_logits,
                                    sentinel)

        exp_logits = torch.exp(sorted_logits)
        cumsum_from_right = torch.flip(
            torch.cumsum(torch.flip(exp_logits, [1]), dim=1), [1])
        log_normalizers = torch.log(cumsum_from_right + self.epsilon)
        log_probs = sorted_logits - log_normalizers
        log_probs = torch.where(sorted_valid_mask, log_probs,
                                torch.zeros_like(log_probs))

        nll = -log_probs.sum(dim=1, keepdim=True)
        nll = torch.where(has_valid, nll, torch.zeros_like(nll))
        return nll, torch.ones_like(nll)

    def call(self, y_true: Any, y_pred: torch.Tensor) -> torch.Tensor:
        y_pred = torch.as_tensor(y_pred)
        y_true, mask = unpack_labels_and_mask(y_true, y_pred.device)
        y_true, y_pred, mask, _ = standardize_call_inputs_ranks(
            y_true, y_pred, mask)
        losses, weights = self.compute_unreduced_loss(
            labels=y_true, logits=y_pred, mask=mask)
        return (losses * weights).squeeze(-1)

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update({"temperature": self.temperature})
        return config
