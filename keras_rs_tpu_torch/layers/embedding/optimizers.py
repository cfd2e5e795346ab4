"""Fused row-wise embedding optimizers (SGD and Adagrad).

Counterpart of keras_rs_tpu/layers/embedding/optimizers.py. `apply` is the
plain PyTorch math on gathered unique rows; the CUDA kernel
(csrc/row_ops.cu) carries the same formulas as template functors, and
ops/row_ops.py's plain version calls `apply`.

  * SGD:      w -= lr * g
  * Adagrad:  acc += g^2;  w -= lr * g / (sqrt(acc) + eps)
              (accumulator initialized to 0.1 like Keras/TPUEmbedding)

Learning rates are floats; schedules (callables of the step), row-wise
Adagrad, Adam and FTRL are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch


class EmbeddingOptimizer:
    """Base: stateless spec; slots are carried by the table state."""

    name = "base"
    slot_names: tuple[str, ...] = ()

    def __init__(self, learning_rate: float = 0.001):
        self.learning_rate = float(learning_rate)

    def init_slot(self, slot_name: str, shape, dtype=torch.float32,
                  device=None) -> torch.Tensor:
        raise NotImplementedError

    def apply(
        self,
        rows: torch.Tensor,  # [U, dim] gathered table rows
        grads: torch.Tensor,  # [U, dim] row gradients
        slots: dict[str, torch.Tensor],  # each [U, dim]
        step: torch.Tensor,  # scalar float step count (0-based)
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        return {"learning_rate": self.learning_rate}


class SGD(EmbeddingOptimizer):
    name = "sgd"
    slot_names = ()

    def __init__(self, learning_rate: float = 0.01):
        super().__init__(learning_rate)

    def apply(self, rows, grads, slots, step):
        return rows - self.learning_rate * grads, {}


class Adagrad(EmbeddingOptimizer):
    name = "adagrad"
    slot_names = ("accumulator",)

    def __init__(
        self,
        learning_rate: float = 0.001,
        initial_accumulator_value: float = 0.1,
        epsilon: float = 1e-7,
    ):
        super().__init__(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.epsilon = epsilon

    def init_slot(self, slot_name, shape, dtype=torch.float32, device=None):
        return torch.full(
            tuple(shape), self.initial_accumulator_value, dtype=dtype,
            device=device,
        )

    def apply(self, rows, grads, slots, step):
        acc = slots["accumulator"] + torch.square(grads)
        update = grads / (torch.sqrt(acc) + self.epsilon)
        return rows - self.learning_rate * update, {"accumulator": acc}

    def get_config(self):
        return {
            **super().get_config(),
            "initial_accumulator_value": self.initial_accumulator_value,
            "epsilon": self.epsilon,
        }


_BY_NAME = {"sgd": SGD, "adagrad": Adagrad}


def get(identifier: Any) -> EmbeddingOptimizer:
    if isinstance(identifier, EmbeddingOptimizer):
        return identifier
    if isinstance(identifier, str):
        if identifier.lower() not in _BY_NAME:
            raise ValueError(
                f"Unknown embedding optimizer {identifier!r}. The port "
                f"supports {sorted(_BY_NAME)} so far."
            )
        return _BY_NAME[identifier.lower()]()
    raise ValueError(f"Cannot interpret optimizer: {identifier!r}")
