"""Embedding table and feature configuration.

Counterpart of keras_rs_tpu/layers/embedding/config.py with the same
fields, defaults, validation and configs (`get_config` / `from_config`,
the same dicts as the JAX package's); initializers and optimizers come
from this package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

from keras_rs_tpu_torch.core import initializers as init_lib
from keras_rs_tpu_torch.types import Shape

PLACEMENTS = ("auto", "sharded", "default_device", "sparsecore")
COMBINERS = ("mean", "sum", "sqrtn")


@dataclasses.dataclass(eq=False)
class TableConfig:
    """Configuration for one embedding table.

    `placement`:
      * "auto": sharded when more than one device is in use, else a
        plain EmbedReduce table (the port runs on one device, so "auto"
        resolves to "default_device").
      * "sharded" (alias "sparsecore"): the stacked table engine with the
        fused-optimizer lookup (lookup.py).
      * "default_device": a plain EmbedReduce table.
    """

    name: str
    vocabulary_size: int
    embedding_dim: int
    initializer: Union[str, Any] = dataclasses.field(
        default_factory=lambda: init_lib.VarianceScaling(mode="fan_out")
    )
    optimizer: Union[str, Any] = "adam"
    combiner: str = "mean"
    placement: str = "auto"
    max_ids_per_partition: int = 256
    max_unique_ids_per_partition: int = 256
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Invalid table dtype {self.dtype!r}; use float32 or "
                "bfloat16."
            )
        if self.combiner not in COMBINERS:
            raise ValueError(
                f"Invalid combiner {self.combiner!r}; use one of {COMBINERS}."
            )
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"Invalid placement {self.placement!r}; use one of "
                f"{PLACEMENTS}."
            )
        if self.vocabulary_size <= 0 or self.embedding_dim <= 0:
            raise ValueError(
                "vocabulary_size and embedding_dim must be positive."
            )

    def get_config(self) -> dict[str, Any]:
        from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib

        initializer = self.initializer
        if not isinstance(initializer, str):
            initializer = init_lib.serialize(initializer)
        optimizer = self.optimizer
        if not isinstance(optimizer, str):
            optimizer = opt_lib.serialize(optimizer)
        return {
            "name": self.name,
            "vocabulary_size": self.vocabulary_size,
            "embedding_dim": self.embedding_dim,
            "initializer": initializer,
            "optimizer": optimizer,
            "combiner": self.combiner,
            "placement": self.placement,
            "max_ids_per_partition": self.max_ids_per_partition,
            "max_unique_ids_per_partition": self.max_unique_ids_per_partition,
            "dtype": self.dtype,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "TableConfig":
        from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib

        config = dict(config)
        if not isinstance(config["initializer"], str):
            config["initializer"] = init_lib.deserialize(
                config["initializer"])
        if not isinstance(config["optimizer"], str):
            config["optimizer"] = opt_lib.deserialize(config["optimizer"])
        return cls(**config)


@dataclasses.dataclass(eq=False)
class FeatureConfig:
    """Binds one input feature to a table.

    `input_shape` is (global_batch_size, valence) and `output_shape`
    (global_batch_size, embedding_dim) when the valence axis is
    combiner-reduced; `output_shape` of rank input rank + 1 keeps one
    embedding per id. Leading axes flatten into one batch axis.
    """

    name: str
    table: TableConfig
    input_shape: Shape
    output_shape: Shape

    def __post_init__(self) -> None:
        if len(self.input_shape) < 1:
            raise ValueError(
                f"`input_shape` must have rank >= 1; got {self.input_shape}."
            )
        if self.output_shape[-1] != self.table.embedding_dim:
            raise ValueError(
                "`output_shape` must end with "
                f"embedding_dim={self.table.embedding_dim}; got "
                f"{self.output_shape}."
            )
        in_shape = tuple(self.input_shape)
        out_lead = tuple(self.output_shape[:-1])
        if out_lead not in (in_shape[:-1], in_shape):
            raise ValueError(
                "`output_shape` leading dims must equal `input_shape` "
                "(one embedding per id) or `input_shape[:-1]` (last axis "
                f"combiner-reduced); got input_shape={self.input_shape}, "
                f"output_shape={self.output_shape}."
            )

    def get_config(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "table": self.table.get_config(),
            "input_shape": tuple(self.input_shape),
            "output_shape": tuple(self.output_shape),
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "FeatureConfig":
        config = dict(config)
        config["table"] = TableConfig.from_config(config["table"])
        return cls(**config)

    @property
    def reduced(self) -> bool:
        """Whether the last input axis is combiner-reduced."""
        return tuple(self.output_shape[:-1]) == tuple(self.input_shape[:-1])

    @property
    def batch_size(self) -> int:
        """Flattened global batch: product of all non-valence axes."""
        lead = (
            self.input_shape[:-1] if self.reduced else self.input_shape
        )
        out = 1
        for d in lead:
            out *= d
        return out

    @property
    def valence(self) -> int:
        return self.input_shape[-1] if self.reduced else 1
