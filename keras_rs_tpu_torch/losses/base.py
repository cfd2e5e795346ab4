"""Loss base class with Keras' reduction semantics (counterpart of
keras_rs_tpu/losses/base.py).

`call` returns per-element losses; `__call__` applies the sample
weights and the reduction:
  * "sum_over_batch_size" (default) and "mean": sum(loss * sw) / numel;
  * "sum": sum(loss * sw);
  * "mean_with_sample_weight": sum(loss * sw) / sum(broadcast sw);
  * None / "none": the weighted losses, unreduced.
"""

from __future__ import annotations

from typing import Any

import torch

_VALID_REDUCTIONS = (
    "sum_over_batch_size",
    "sum",
    "mean",
    "mean_with_sample_weight",
    "none",
    None,
)


class Loss:
    def __init__(
        self,
        reduction: str | None = "sum_over_batch_size",
        name: str | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError(
                f"Invalid `reduction`: {reduction!r}. Must be one of "
                f"{_VALID_REDUCTIONS}."
            )
        self.reduction = reduction
        self.name = name or type(self).__name__
        self.dtype = dtype

    def call(self, y_true: Any, y_pred: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(
        self,
        y_true: Any,
        y_pred: torch.Tensor,
        sample_weight: Any = None,
    ) -> torch.Tensor:
        losses = self.call(y_true, y_pred).to(self.dtype)
        if sample_weight is not None:
            sample_weight = torch.as_tensor(
                sample_weight, dtype=self.dtype, device=losses.device)
            # Align trailing dims: (B,) weights against (B, L) losses, etc.
            while sample_weight.ndim < losses.ndim:
                sample_weight = sample_weight[..., None]
            losses = losses * sample_weight

        if self.reduction in (None, "none"):
            return losses
        total = losses.sum()
        if self.reduction == "sum":
            return total
        if (self.reduction == "mean_with_sample_weight"
                and sample_weight is not None):
            return total / sample_weight.broadcast_to(losses.shape).sum()
        # "sum_over_batch_size", "mean", unweighted "mean_with_sample_weight"
        return total / losses.numel()

    def get_config(self) -> dict[str, Any]:
        return {"reduction": self.reduction, "name": self.name}


def unpack_labels_and_mask(
    y_true: Any, device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Unpacks the `{"labels": ..., "mask": ...}` dict protocol; both come
    back as tensors on `device`."""
    mask = None
    if isinstance(y_true, dict):
        if "labels" not in y_true:
            raise ValueError(
                '`"labels"` should be present in `y_true`. Received: '
                f"`y_true` = {y_true}"
            )
        mask = y_true.get("mask", None)
        y_true = y_true["labels"]
    y_true = torch.as_tensor(y_true, device=device)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device)
    return y_true, mask
