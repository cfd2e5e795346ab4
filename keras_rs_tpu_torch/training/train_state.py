"""Train step (counterpart of keras_rs_tpu/training/train_state.py).

A step has two halves, as in the JAX package:
  * dense parameters (MLPs, FeatureCross, small EmbedReduce tables, all
    of SASRec) are the model's `nn.Parameter`s and take Adagrad or Adam
    in optax's formula (`DenseAdagrad`, `DenseAdam`);
  * stacked embedding tables are buffers, not parameters: their fused
    optimizer runs inside the lookup's backward pass and writes the new
    rows in place (the Overwrite contract of the JAX package,
    lookup.py's `_StackLookup`).

Over a mesh of D > 1 ranks the step is data parallel in the dense
parameters: each rank holds a replica (equal from the start: every rank
builds the model from the same generator seed) and its B / D samples;
the loss of the global batch is the mean of the ranks' local means, so
each rank back-propagates its local loss / D (which is also the
cotangent scale the sharded lookup's update needs) and the dense
gradients are summed over the ranks in one all_reduce before the
optimizer, which then takes the same step on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.parallel import collectives


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

    def state_dict(self) -> dict[str, Any]:
        """The accumulators (the tensors themselves, in parameter order)."""
        return {"accumulators": list(self.accumulators)}

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Copies a `state_dict` into the accumulators in place."""
        _copy_into(self.accumulators, state["accumulators"], "accumulators")


class DenseAdam:
    """`optax.adam` (scale_by_adam + scale_by_learning_rate) with optax's
    defaults b1 0.9, b2 0.999, eps_root 0, at step t = 1, 2, ...:

        mu = (1 - b1) * g   + b1 * mu
        nu = (1 - b2) * g^2 + b2 * nu
        p += -lr * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps))

    with mu and nu from 0 and eps (default 1e-8) outside the root.
    Parameters whose gradient is None are left alone (their moments do
    not move, but t counts every step, as optax's count does).
    """

    B1, B2 = 0.9, 0.999

    def __init__(self, params: Iterable[nn.Parameter], learning_rate: float,
                 eps: float = 1e-8):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.eps = eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        # Bias corrections in f32, as optax computes decay**count, and as
        # Python numbers: no tensor crosses to the device (that copy would
        # wait for the device once per parameter).
        b1, b2 = np.float32(self.B1), np.float32(self.B2)
        c1 = float(np.float32(1) - b1 ** np.float32(self.count))
        c2 = float(np.float32(1) - b2 ** np.float32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            if g is None:
                continue
            mu.copy_((1 - self.B1) * g + self.B1 * mu)
            nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(update * (-self.learning_rate))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict[str, Any]:
        """The step count and both moments (the tensors themselves)."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Copies a `state_dict` into the moments in place."""
        _copy_into(self.mu, state["mu"], "mu")
        _copy_into(self.nu, state["nu"], "nu")
        self.count = int(state["count"])


def _copy_into(dst: list[torch.Tensor], src: list[torch.Tensor],
               name: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} tensors for {len(dst)} "
                         "parameters.")
    for i, (d, v) in enumerate(zip(dst, src)):
        if tuple(d.shape) != tuple(v.shape):
            raise ValueError(f"{name}[{i}]: shape {tuple(v.shape)} for "
                             f"{tuple(d.shape)}.")
        d.copy_(v)


def map_tensors(tree: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """`fn` over every tensor of a dict / tuple / list / NamedTuple
    structure; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        items = [map_tensors(v, fn) for v in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return tree


def sum_gradients(params: list[nn.Parameter], group) -> None:
    """Every parameter's gradient summed over the ranks of `group`, in
    place, in one all_reduce of the flattened gradients (a parameter
    without a gradient counts as zeros and gets them, so every rank
    flattens the same layout)."""
    if not params:
        return
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = collectives.all_reduce(
        torch.cat([g.reshape(-1) for g in grads]), group)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def make_train_step(
    model: nn.Module,
    loss_fn: Callable[[nn.Module, Any], Any],
    optimizer: DenseAdagrad | DenseAdam,
    has_aux: bool = False,
    mesh: Any = None,
) -> Callable[[Any], Any]:
    """`step(batch) -> loss` (detached): forward, backward (which also
    updates the stacked embedding tables in place), dense optimizer.

    With `has_aux`, `loss_fn` returns `(loss, aux)` and the step returns
    `(loss, aux)`, both detached, the aux as the loss function gave it
    (no host read), as the JAX step does.

    With a `mesh` (parallel/mesh.py) of D > 1 ranks, `batch` is this
    rank's B / D samples and `loss_fn` their mean loss: the step is data
    parallel as the module docstring says, and returns the global
    batch's loss (an all_reduce of the ranks' losses); the aux stays
    this rank's."""
    D = 1 if mesh is None else mesh.size
    group = None if D == 1 else mesh.group(mesh.axis_names)

    def step(batch: Any) -> Any:
        optimizer.zero_grad()
        out = loss_fn(model, batch)
        loss = out[0] if has_aux else out
        if D == 1:
            loss.backward()
        else:
            (loss / D).backward()
            sum_gradients(optimizer.params, group)
            loss = collectives.all_reduce(loss.detach().clone(), group) / D
        optimizer.step()
        if has_aux:
            return loss.detach(), map_tensors(out[1], torch.Tensor.detach)
        return loss.detach()

    return step
