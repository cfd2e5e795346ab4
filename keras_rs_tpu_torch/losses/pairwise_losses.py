"""Pairwise ranking losses: hinge, logistic, soft zero-one, pairwise MSE
(counterpart of keras_rs_tpu/losses/pairwise_losses.py).

The (B, L, L) pairwise tensors are built by broadcasting; the sum over
the j axis leaves (B, L) per-item losses, the reference's reduction
contract.
"""

from __future__ import annotations

from typing import Any

import torch

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.losses.base import Loss, unpack_labels_and_mask
from keras_rs_tpu_torch.ops.pairwise import (
    apply_pairwise_op,
    pairwise_comparison,
)
from keras_rs_tpu_torch.ops.ranking import standardize_call_inputs_ranks


class PairwiseLoss(Loss):
    """Base class of the pairwise ranking losses:

        loss_i = sum_j I(y_i > y_j) * pairwise_loss((s_i - s_j) / temperature)

    Labels < 0 are invalid and excluded; a mask given through the
    `{"labels", "mask"}` dict protocol of `y_true` is ANDed in.
    """

    def __init__(self, temperature: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if temperature <= 0.0:
            raise ValueError(
                "`temperature` should be a positive float. Received: "
                f"`temperature` = {temperature}."
            )
        self.temperature = temperature

    def pairwise_loss(self, pairwise_logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compute_unreduced_loss(
        self,
        labels: torch.Tensor,
        logits: torch.Tensor,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = torch.logical_and(valid_mask, mask)
        pairwise_labels, pairwise_logits = pairwise_comparison(
            labels=labels, logits=logits, mask=valid_mask,
            logits_op=torch.subtract,
        )
        pairwise_logits = pairwise_logits / self.temperature
        return self.pairwise_loss(pairwise_logits), pairwise_labels

    def call(self, y_true: Any, y_pred: torch.Tensor) -> torch.Tensor:
        y_pred = torch.as_tensor(y_pred)
        y_true, mask = unpack_labels_and_mask(y_true, y_pred.device)
        y_true, y_pred, mask, _ = standardize_call_inputs_ranks(
            y_true, y_pred, mask)
        losses, weights = self.compute_unreduced_loss(
            labels=y_true, logits=y_pred, mask=mask)
        return (losses * weights).sum(dim=-1)

    def get_config(self) -> dict[str, Any]:
        config = super().get_config()
        config.update({"temperature": self.temperature})
        return config


@export("keras_rs_tpu_torch.losses.PairwiseHingeLoss")
class PairwiseHingeLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * max(0, 1 - (s_i - s_j))."""

    def pairwise_loss(self, pairwise_logits: torch.Tensor) -> torch.Tensor:
        hinge = 1.0 - pairwise_logits
        # torch.maximum, as jnp.maximum, halves the gradient at a tie.
        return torch.maximum(hinge, torch.zeros_like(hinge))


@export("keras_rs_tpu_torch.losses.PairwiseLogisticLoss")
class PairwiseLogisticLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * log(1 + exp(-(s_i - s_j))),
    in the stable form relu(-d) + log(1 + exp(-|d|)) of the reference."""

    def pairwise_loss(self, pairwise_logits: torch.Tensor) -> torch.Tensor:
        d = pairwise_logits
        # |d| whose gradient at 0 is +1, as jnp.abs's is (torch.abs's is 0).
        abs_d = torch.where(d >= 0.0, d, -d)
        return torch.maximum(-d, torch.zeros_like(d)) + torch.log(
            1.0 + torch.exp(-abs_d))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The reference's own sigmoid, 1 / (1 + exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


@export("keras_rs_tpu_torch.losses.PairwiseSoftZeroOneLoss")
class PairwiseSoftZeroOneLoss(PairwiseLoss):
    """loss = sum_i sum_j I(y_i > y_j) * soft_zero_one(s_i - s_j), with
    soft_zero_one(d) = 1 - sigmoid(d) if d > 0 else sigmoid(-d)."""

    def pairwise_loss(self, pairwise_logits: torch.Tensor) -> torch.Tensor:
        return torch.where(
            pairwise_logits > 0.0,
            1.0 - _sigmoid(pairwise_logits),
            _sigmoid(-pairwise_logits),
        )


@export("keras_rs_tpu_torch.losses.PairwiseMeanSquaredError")
class PairwiseMeanSquaredError(PairwiseLoss):
    """loss = sum_i sum_j ((y_i - y_j) - (s_i - s_j))^2 over valid pairs:
    every valid ordered pair contributes (not only y_i > y_j), self-pairs
    excluded."""

    def pairwise_loss(self, pairwise_logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError  # unused: compute_unreduced_loss overridden

    def compute_unreduced_loss(
        self,
        labels: torch.Tensor,
        logits: torch.Tensor,
        mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        list_size = labels.shape[1]
        valid_mask = labels >= 0.0
        if mask is not None:
            valid_mask = torch.logical_and(valid_mask, mask)
        pairwise_labels_diff = apply_pairwise_op(labels, torch.subtract)
        pairwise_logits_diff = apply_pairwise_op(logits, torch.subtract)
        valid_pair = apply_pairwise_op(valid_mask, torch.logical_and)
        pairwise_mse = torch.square(pairwise_labels_diff
                                    - pairwise_logits_diff)
        pairwise_weights = torch.ones_like(pairwise_mse) - torch.eye(
            list_size, dtype=pairwise_mse.dtype, device=pairwise_mse.device)
        pairwise_weights = pairwise_weights * valid_pair.to(
            pairwise_weights.dtype)
        return pairwise_mse, pairwise_weights
