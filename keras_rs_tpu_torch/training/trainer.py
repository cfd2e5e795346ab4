"""Host-side training loop (counterpart of keras_rs_tpu/training/trainer.py).

An explicit loop around `make_train_step`. Each batch is a dict of numpy
arrays or tensors and moves to the device of the model's parameters
before the step. The JAX Trainer's checkpointing, profiling, prefetch,
validation, metrics log and `evaluate` are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.training.train_state import make_train_step

logger = logging.getLogger("keras_rs_tpu_torch")


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Every value of `batch` as a tensor on `device`."""
    return {
        k: (v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v))).to(device)
        for k, v in batch.items()
    }


class Trainer:
    """Minimal, explicit trainer.

    Args:
        model: an nn.Module.
        optimizer: an object with `step()` and `zero_grad()` over the
            model's parameters (`DenseAdam`, `DenseAdagrad`).
        loss_fn: callable (model, batch) -> scalar loss.
    """

    def __init__(self, model: nn.Module, optimizer: Any,
                 loss_fn: Callable[[nn.Module, dict], torch.Tensor]) -> None:
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = next(model.parameters()).device
        self._step_fn = make_train_step(model, loss_fn, optimizer)

    def step(self, batch: dict) -> torch.Tensor:
        """One training step; returns the detached loss (no host sync)."""
        return self._step_fn(batch_to_device(batch, self.device))

    def fit(
        self,
        data: Iterable[dict] | Callable[[], Iterable[dict]],
        *,
        epochs: int = 1,
        steps_per_epoch: int | None = None,
        log_every: int = 100,
    ) -> dict[str, list[float]]:
        """Runs the loop; returns {"loss": [mean step loss per epoch]}.
        For more than one epoch pass a callable that returns a fresh
        iterator per epoch."""
        history: dict[str, list[float]] = {"loss": []}
        for epoch in range(epochs):
            epoch_data = data() if callable(data) else data
            losses = []
            t0 = time.time()
            for i, batch in enumerate(epoch_data):
                if steps_per_epoch is not None and i >= steps_per_epoch:
                    break
                losses.append(self.step(batch))
                if log_every and (i + 1) % log_every == 0:
                    logger.info("epoch %d step %d loss %.5f", epoch, i + 1,
                                float(losses[-1]))
            if not losses:
                raise ValueError(
                    "Dataset yielded no batches. For multi-epoch training "
                    "pass a callable returning a fresh iterator per epoch."
                )
            epoch_loss = float(np.mean([float(l) for l in losses]))
            history["loss"].append(epoch_loss)
            logger.info("epoch %d done in %.1fs loss %.5f", epoch,
                        time.time() - t0, epoch_loss)
        return history
