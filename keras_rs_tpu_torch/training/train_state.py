"""Train step (counterpart of keras_rs_tpu/training/train_state.py).

A step has two halves, as in the JAX package:
  * dense parameters (MLPs, FeatureCross, small EmbedReduce tables) are
    the model's `nn.Parameter`s and take Adagrad in optax's formula
    (`DenseAdagrad`);
  * stacked embedding tables are buffers, not parameters: their fused
    optimizer runs inside the lookup's backward pass and writes the new
    rows in place (the Overwrite contract of the JAX package,
    lookup.py's `_StackLookup`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
from torch import nn


class DenseAdagrad:
    """`optax.adagrad` (scale_by_rss + scale_by_learning_rate):

        acc += g^2
        p   += -lr * (g * rsqrt(acc + eps))   (0 where acc == 0)

    with initial_accumulator_value 0.1 and eps 1e-7 inside the root.
    (`torch.optim.Adagrad` computes g / (sqrt(acc) + eps) and starts its
    accumulator at 0, so it is a different optimizer.) Parameters whose
    gradient is None are left alone.
    """

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        learning_rate: float,
        initial_accumulator_value: float = 0.1,
        eps: float = 1e-7,
    ):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.eps = eps
        self.accumulators = [
            torch.full_like(p, initial_accumulator_value,
                            memory_format=torch.preserve_format)
            for p in self.params
        ]

    @torch.no_grad()
    def step(self) -> None:
        for p, acc in zip(self.params, self.accumulators):
            g = p.grad
            if g is None:
                continue
            acc.add_(g * g)
            inv = torch.where(
                acc > 0, torch.rsqrt(acc + self.eps), torch.zeros_like(acc)
            )
            p.add_((inv * g) * (-self.learning_rate))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], torch.Tensor],
    optimizer: DenseAdagrad,
) -> Callable[[Any], torch.Tensor]:
    """`step(batch) -> loss` (detached): forward, backward (which also
    updates the stacked embedding tables in place), dense optimizer."""

    def step(batch: Any) -> torch.Tensor:
        optimizer.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
