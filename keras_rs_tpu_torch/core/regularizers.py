"""Weight regularizers (L1 / L2 / L1L2) and the module-tree penalty
(counterpart of keras_rs_tpu/core/regularizers.py).

Layers that take regularizers record them in a `_regularizers` dict
{attribute name: Regularizer}; `regularization_loss(model)` walks
`model.modules()` and sums `reg(getattr(m, attr))` over every entry.
Add it to the loss inside the loss function, so that the penalty is part
of the graph the backward differentiates:

    def loss_fn(model, batch):
        return data_loss(model, batch) + regularization_loss(model)

Penalties as keras.regularizers: L1 = l1 * sum(|x|), L2 = l2 * sum(x^2)
(not 1/2 * sum(x^2)).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


class Regularizer:
    """Base class; subclasses implement `__call__(x) -> 0-dim tensor`."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_config(self) -> dict[str, Any]:
        return {}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "Regularizer":
        return cls(**config)

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.get_config().items())
        return f"{type(self).__name__}({cfg})"


class L1L2(Regularizer):
    """`l1 * sum(|x|) + l2 * sum(x^2)` (keras.regularizers.L1L2)."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0) -> None:
        self.l1 = float(l1)
        self.l2 = float(l2)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((), dtype=torch.promote_types(x.dtype,
                                                        torch.float32),
                          device=x.device)
        if self.l1:
            out = out + self.l1 * torch.sum(torch.abs(x))
        if self.l2:
            out = out + self.l2 * torch.sum(torch.square(x))
        return out

    def get_config(self) -> dict[str, Any]:
        return {"l1": self.l1, "l2": self.l2}

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and (self.l1, self.l2) == (
            other.l1, other.l2)

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.l1, self.l2))


class L1(L1L2):
    def __init__(self, l1: float = 0.01) -> None:
        super().__init__(l1=l1)

    def get_config(self) -> dict[str, Any]:
        return {"l1": self.l1}


class L2(L1L2):
    def __init__(self, l2: float = 0.01) -> None:
        super().__init__(l2=l2)

    def get_config(self) -> dict[str, Any]:
        return {"l2": self.l2}


_BY_NAME = {"l1": L1, "l2": L2, "l1_l2": L1L2, "l1l2": L1L2}


class _Wrapped(Regularizer):
    """Adapter for a bare callable `x -> 0-dim tensor`."""

    def __init__(self, fn: Any) -> None:
        self.fn = fn

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def get_config(self) -> dict[str, Any]:
        raise ValueError(
            "Callable regularizers cannot be serialized; use L1/L2/L1L2."
        )


def get(identifier: Any) -> Regularizer | None:
    """Resolves a regularizer like keras.regularizers.get (None passes)."""
    if identifier is None or isinstance(identifier, Regularizer):
        return identifier
    if isinstance(identifier, str):
        name = identifier.lower()
        if name in _BY_NAME:
            return _BY_NAME[name]()
        raise ValueError(f"Unknown regularizer: {identifier!r}")
    if callable(identifier):
        return _Wrapped(identifier)
    raise ValueError(f"Cannot interpret regularizer: {identifier!r}")


def serialize(reg: Regularizer | None) -> dict[str, Any] | None:
    if reg is None:
        return None
    return {"class_name": type(reg).__name__, "config": reg.get_config()}


def deserialize(spec: Any) -> Regularizer | None:
    if spec is None:
        return None
    if isinstance(spec, str):
        return get(spec)
    by_class = {"L1": L1, "L2": L2, "L1L2": L1L2}
    return by_class[spec["class_name"]].from_config(spec["config"])


def regularization_loss(module: nn.Module) -> torch.Tensor:
    """The sum of every registered weight penalty under `module`: a
    differentiable 0-dim f32 tensor on the parameters' device (0 when
    nothing is registered)."""
    total = None
    for m in module.modules():
        for attr, reg in getattr(m, "_regularizers", {}).items():
            value = getattr(m, attr, None)
            if value is None or reg is None:
                continue
            term = reg(value)
            total = term if total is None else total + term
    if total is None:
        first = next(iter(module.parameters()), None)
        if first is None:
            first = next(iter(module.buffers()), None)
        device = None if first is None else first.device
        return torch.zeros((), dtype=torch.float32, device=device)
    return total
