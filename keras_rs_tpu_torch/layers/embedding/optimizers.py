"""Fused row-wise embedding optimizers.

Counterpart of keras_rs_tpu/layers/embedding/optimizers.py. `apply` is the
plain PyTorch math on gathered unique rows, in the JAX package's formulas;
the CUDA kernel of csrc/row_ops.cu carries SGD and Adagrad as template
functors (packed stacks), and the split-layout backward runs `apply` in
PyTorch before the row-scatter kernel writes the rows back.

  * SGD:             w -= lr * g
  * Adagrad:         acc += g^2;  w -= lr * g / (sqrt(acc) + eps)
                     (accumulator initialized to 0.1 like Keras/TPUEmbedding)
  * RowWiseAdagrad:  acc += sum(g^2, -1) (one f32 per row);
                     w -= lr * g / (sqrt(acc) + eps)
  * Adam:            t = step + 1, bias-corrected moments, eps outside the
                     square root
  * FTRL:            keras.optimizers.Ftrl, with l2_shrinkage and beta

Learning rates are floats or callables of the step (a schedule): the
callable takes the stack's 0-dim f32 step counter (0-based) on its device
and returns the rate as a tensor, evaluated on the device inside the
update, so a schedule adds no host sync (B1 reads it from its scalars
buffer).
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch

LearningRate = Union[float, Callable[[torch.Tensor], Any]]


class EmbeddingOptimizer:
    """Base: stateless spec; slots are carried by the table state."""

    name = "base"
    slot_names: tuple[str, ...] = ()
    #: Slots listed here hold one f32 per row ([R] 1-D tensors) instead of
    #: a [R, dim] buffer; their `apply` inputs and outputs are [U] vectors.
    rowwise_slots: tuple[str, ...] = ()

    def __init__(self, learning_rate: LearningRate = 0.001):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else float(learning_rate))

    def lr(self, step: torch.Tensor) -> float | torch.Tensor:
        """The rate at `step`: the float, or the schedule's value as a
        0-dim f32 tensor. A schedule computes it from `step` on the
        device and must return a tensor."""
        if not callable(self.learning_rate):
            return self.learning_rate
        value = self.learning_rate(step)
        if not isinstance(value, torch.Tensor):
            raise TypeError(
                "A learning-rate schedule must return a tensor computed "
                f"from the step tensor, not {type(value).__name__}."
            )
        return value.to(torch.float32).reshape(())

    def init_slot(self, slot_name: str, shape, dtype=torch.float32,
                  device=None) -> torch.Tensor:
        """A new slot of `shape` holding its initial value."""
        return self.fill_slot_(
            slot_name, torch.empty(tuple(shape), dtype=dtype, device=device)
        )

    def fill_slot_(self, slot_name: str, out: torch.Tensor) -> torch.Tensor:
        """Writes the slot's initial value into `out` in place (a view
        such as a packed state's slot rows) and returns it."""
        raise NotImplementedError

    def apply(
        self,
        rows: torch.Tensor,  # [U, dim] gathered table rows
        grads: torch.Tensor,  # [U, dim] row gradients
        slots: dict[str, torch.Tensor],  # each [U, dim] ([U] if row-wise)
        step: torch.Tensor,  # scalar float step count (0-based)
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        if callable(self.learning_rate):
            raise ValueError(
                "Callable learning rates cannot be serialized; pass a float."
            )
        return {"learning_rate": self.learning_rate}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "EmbeddingOptimizer":
        """The optimizer of a `get_config` dict."""
        return cls(**config)


class SGD(EmbeddingOptimizer):
    name = "sgd"
    slot_names = ()

    def __init__(self, learning_rate: LearningRate = 0.01):
        super().__init__(learning_rate)

    def apply(self, rows, grads, slots, step):
        return rows - self.lr(step) * grads, {}


class Adagrad(EmbeddingOptimizer):
    name = "adagrad"
    slot_names = ("accumulator",)

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        initial_accumulator_value: float = 0.1,
        epsilon: float = 1e-7,
    ):
        super().__init__(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.epsilon = epsilon

    def fill_slot_(self, slot_name, out):
        return out.fill_(self.initial_accumulator_value)

    def apply(self, rows, grads, slots, step):
        acc = slots["accumulator"] + torch.square(grads)
        update = grads / (torch.sqrt(acc) + self.epsilon)
        return rows - self.lr(step) * update, {"accumulator": acc}

    def get_config(self):
        return {
            **super().get_config(),
            "initial_accumulator_value": self.initial_accumulator_value,
            "epsilon": self.epsilon,
        }


class RowWiseAdagrad(Adagrad):
    """Adagrad with one accumulator per row: the sum (not the mean) of the
    row's squared gradient, so zero-padded stack columns change nothing.
    With a bf16 table the state is 2 * dim + 4 bytes per row (260 at dim
    128) instead of the packed f32 + Adagrad's 8 * dim."""

    name = "rowwise_adagrad"
    rowwise_slots = ("accumulator",)

    def apply(self, rows, grads, slots, step):
        acc = slots["accumulator"] + torch.sum(torch.square(grads), dim=-1)
        update = grads / (torch.sqrt(acc)[:, None] + self.epsilon)
        return rows - self.lr(step) * update, {"accumulator": acc}


class Adam(EmbeddingOptimizer):
    name = "adam"
    slot_names = ("momentum", "velocity")

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-7,
    ):
        super().__init__(learning_rate)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon

    def fill_slot_(self, slot_name, out):
        return out.zero_()

    def apply(self, rows, grads, slots, step):
        t = step + 1.0
        m = self.beta_1 * slots["momentum"] + (1.0 - self.beta_1) * grads
        v = self.beta_2 * slots["velocity"] + (
            1.0 - self.beta_2
        ) * torch.square(grads)
        m_hat = m / (1.0 - torch.pow(self.beta_1, t))
        v_hat = v / (1.0 - torch.pow(self.beta_2, t))
        update = m_hat / (torch.sqrt(v_hat) + self.epsilon)
        return rows - self.lr(step) * update, {
            "momentum": m,
            "velocity": v,
        }

    def get_config(self):
        return {
            **super().get_config(),
            "beta_1": self.beta_1,
            "beta_2": self.beta_2,
            "epsilon": self.epsilon,
        }


class FTRL(EmbeddingOptimizer):
    name = "ftrl"
    slot_names = ("accumulator", "linear")

    def __init__(
        self,
        learning_rate: LearningRate = 0.001,
        learning_rate_power: float = -0.5,
        initial_accumulator_value: float = 0.1,
        l1_regularization_strength: float = 0.0,
        l2_regularization_strength: float = 0.0,
        l2_shrinkage_regularization_strength: float = 0.0,
        beta: float = 0.0,
    ):
        super().__init__(learning_rate)
        self.learning_rate_power = learning_rate_power
        self.initial_accumulator_value = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength
        self.beta = beta

    def fill_slot_(self, slot_name, out):
        if slot_name == "accumulator":
            return out.fill_(self.initial_accumulator_value)
        return out.zero_()

    def apply(self, rows, grads, slots, step):
        # keras.optimizers.Ftrl: the accumulator takes the raw gradient,
        # the linear term the shrinkage-adjusted g + 2 * l2_shrinkage * w,
        # and beta adds beta / lr to the quadratic.
        lr = self.lr(step)
        p = -self.learning_rate_power
        acc, linear = slots["accumulator"], slots["linear"]
        new_acc = acc + torch.square(grads)
        sigma = (torch.pow(new_acc, p) - torch.pow(acc, p)) / lr
        grads_lin = (
            grads + 2.0 * self.l2_shrinkage * rows
            if self.l2_shrinkage
            else grads
        )
        new_linear = linear + grads_lin - sigma * rows
        quadratic = torch.pow(new_acc, p) / lr + 2.0 * self.l2 + self.beta / lr
        pruned = torch.where(
            torch.abs(new_linear) > self.l1,
            self.l1 * torch.sign(new_linear) - new_linear,
            torch.zeros_like(new_linear),
        )
        return pruned / quadratic, {
            "accumulator": new_acc,
            "linear": new_linear,
        }

    def get_config(self):
        return {
            **super().get_config(),
            "learning_rate_power": self.learning_rate_power,
            "initial_accumulator_value": self.initial_accumulator_value,
            "l1_regularization_strength": self.l1,
            "l2_regularization_strength": self.l2,
            "l2_shrinkage_regularization_strength": self.l2_shrinkage,
            "beta": self.beta,
        }


_BY_NAME = {
    "sgd": SGD,
    "adagrad": Adagrad,
    "rowwise_adagrad": RowWiseAdagrad,
    "adam": Adam,
    "ftrl": FTRL,
}


def get(identifier: Any) -> EmbeddingOptimizer:
    if isinstance(identifier, EmbeddingOptimizer):
        return identifier
    if isinstance(identifier, str):
        if identifier.lower() not in _BY_NAME:
            raise ValueError(
                f"Unknown embedding optimizer {identifier!r}. The port "
                f"supports {sorted(_BY_NAME)}."
            )
        return _BY_NAME[identifier.lower()]()
    raise ValueError(f"Cannot interpret optimizer: {identifier!r}")


def serialize(optimizer: EmbeddingOptimizer) -> dict[str, Any]:
    return {"class_name": optimizer.name, "config": optimizer.get_config()}


def deserialize(spec: Any) -> EmbeddingOptimizer:
    """A name (as `get`) or {"class_name": name, "config": kwargs} ->
    optimizer."""
    if isinstance(spec, str):
        return get(spec)
    return _BY_NAME[spec["class_name"]](**spec["config"])
