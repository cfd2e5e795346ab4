"""Registry-based serialization (counterpart of
keras_rs_tpu/core/serialization.py).

`@export("keras_rs_tpu_torch.layers.X")` registers a class under its
public path (and its bare class name); `serialize(obj)` gives
{"class_name": path, "config": obj.get_config()} and `deserialize(spec)`
rebuilds the object from its config. Configs carry the architecture, not
the weights, which come from a checkpoint (training/checkpoint.py).
"""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, type] = {}
_REVERSE: dict[type, str] = {}


def export(path: str | tuple[str, ...]) -> Callable[[type], type]:
    """Class decorator registering the class under its public path(s)."""

    paths = (path,) if isinstance(path, str) else tuple(path)

    def decorator(cls: type) -> type:
        for p in paths:
            if p in _REGISTRY and _REGISTRY[p] is not cls:
                raise ValueError(f"Duplicate export path: {p}")
            _REGISTRY[p] = cls
        _REVERSE.setdefault(cls, paths[0])
        _REGISTRY.setdefault(cls.__name__, cls)
        return cls

    return decorator


def get_registered_name(cls: type) -> str:
    return _REVERSE.get(cls, cls.__name__)


def get_registered_class(name: str) -> type:
    if name not in _REGISTRY:
        raise ValueError(f"Unknown registered class: {name!r}")
    return _REGISTRY[name]


def serialize(obj: Any) -> dict[str, Any] | None:
    if obj is None:
        return None
    return {
        "class_name": get_registered_name(type(obj)),
        "config": obj.get_config(),
    }


def deserialize(spec: Any, **kwargs: Any) -> Any:
    """Rebuilds a `serialize` spec: the class's `from_config(config)`
    where it has one, else `cls(**config)`. `kwargs` (e.g. `device=`)
    are run-time arguments that the config does not carry."""
    if spec is None:
        return None
    cls = get_registered_class(spec["class_name"])
    config = {**spec["config"], **kwargs}
    from_config = getattr(cls, "from_config", None)
    return from_config(config) if from_config is not None else cls(**config)
