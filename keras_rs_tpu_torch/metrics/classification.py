"""Streaming binary-classification metrics: AUC and BinaryAccuracy.

Counterpart of keras_rs_tpu/metrics/classification.py, with the state as
tensors on the metric's device, so an evaluation loop accumulates on the
device and reads one number at the end. Each metric has the functional
form (`init_state`, `update`, `result_from_state`) and the stateful one
(`update_state`, `result`, `reset_state`).

AUC is Keras' thresholded approximation: `num_thresholds` evenly spaced
thresholds accumulate confusion-matrix counts, and the result integrates
the ROC curve by trapezoids.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.utils.device import resolve_device

_EPSILON = 1e-7


class ConfusionState(NamedTuple):
    """Per-threshold confusion counts [T]."""

    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor


class MeanPair(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor


def _flat(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).reshape(-1).float()


def _weights(sample_weight: Any, like: torch.Tensor) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones_like(like)
    return torch.as_tensor(sample_weight, device=like.device).float(
    ).broadcast_to(like.shape)


@export("keras_rs_tpu_torch.metrics.AUC")
class AUC:
    """Streaming ROC-AUC (thresholded approximation, Keras parity)."""

    def __init__(self, num_thresholds: int = 200, name: str | None = None,
                 device: Any = None) -> None:
        if num_thresholds < 2:
            raise ValueError("num_thresholds must be >= 2")
        self.num_thresholds = num_thresholds
        self.name = name or "auc"
        self.device = resolve_device(device)
        # Keras thresholds: {-eps, evenly spaced interior, 1 + eps}.
        self.thresholds = torch.arange(
            num_thresholds, dtype=torch.float32, device=self.device
        ) / (num_thresholds - 1)
        self.thresholds[0] = -_EPSILON
        self.thresholds[-1] = 1.0 + _EPSILON
        self._state: ConfusionState | None = None

    def init_state(self) -> ConfusionState:
        return ConfusionState(*(
            torch.zeros(self.num_thresholds, device=self.device)
            for _ in range(4)
        ))

    def update(self, state: ConfusionState, y_true: Any, y_pred: Any,
               sample_weight: Any = None) -> ConfusionState:
        y_true = _flat(y_true, self.device)
        y_pred = _flat(y_pred, self.device)
        w = _weights(sample_weight, y_true)
        # [T, N]: strictly above the threshold counts as positive (a
        # prediction equal to an interior threshold is negative).
        pred_pos = y_pred[None, :] > self.thresholds[:, None]
        pos = (y_true > 0.5)[None, :]
        w = w[None, :]

        def count(mask: torch.Tensor) -> torch.Tensor:
            return torch.where(mask, w, 0.0).sum(dim=1)

        return ConfusionState(
            tp=state.tp + count(pred_pos & pos),
            fp=state.fp + count(pred_pos & ~pos),
            tn=state.tn + count(~pred_pos & ~pos),
            fn=state.fn + count(~pred_pos & pos),
        )

    def result_from_state(self, state: ConfusionState) -> torch.Tensor:
        tpr = state.tp / torch.clamp(state.tp + state.fn, min=_EPSILON)
        fpr = state.fp / torch.clamp(state.fp + state.tn, min=_EPSILON)
        # Thresholds ascend, so the rates descend: trapezoids over FPR.
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)

    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(self, y_true: Any, y_pred: Any,
                     sample_weight: Any = None) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(self._state, y_true, y_pred,
                                  sample_weight)

    def result(self) -> torch.Tensor:
        if self._state is None:
            return torch.zeros((), device=self.device)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {"num_thresholds": self.num_thresholds, "name": self.name}


@export("keras_rs_tpu_torch.metrics.BinaryAccuracy")
class BinaryAccuracy:
    """Streaming accuracy at a probability threshold (default 0.5)."""

    def __init__(self, threshold: float = 0.5, name: str | None = None,
                 device: Any = None) -> None:
        self.threshold = float(threshold)
        self.name = name or "binary_accuracy"
        self.device = resolve_device(device)
        self._state: MeanPair | None = None

    def init_state(self) -> MeanPair:
        return MeanPair(torch.zeros((), device=self.device),
                        torch.zeros((), device=self.device))

    def update(self, state: MeanPair, y_true: Any, y_pred: Any,
               sample_weight: Any = None) -> MeanPair:
        y_true = _flat(y_true, self.device)
        y_pred = _flat(y_pred, self.device)
        w = _weights(sample_weight, y_true)
        # Strictly above the threshold, as keras.metrics.binary_accuracy.
        correct = (y_pred > self.threshold) == (y_true > 0.5)
        return MeanPair(
            total=state.total + torch.where(correct, w, 0.0).sum(),
            count=state.count + w.sum(),
        )

    def result_from_state(self, state: MeanPair) -> torch.Tensor:
        return state.total / torch.clamp(state.count, min=_EPSILON)

    def reset_state(self) -> None:
        self._state = self.init_state()

    def update_state(self, y_true: Any, y_pred: Any,
                     sample_weight: Any = None) -> None:
        if self._state is None:
            self._state = self.init_state()
        self._state = self.update(self._state, y_true, y_pred,
                                  sample_weight)

    def result(self) -> torch.Tensor:
        if self._state is None:
            return torch.zeros((), device=self.device)
        return self.result_from_state(self._state)

    def get_config(self) -> dict[str, Any]:
        return {"threshold": self.threshold, "name": self.name}
