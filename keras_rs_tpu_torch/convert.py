"""Loads parameters exported from the JAX package into the port's modules.

The caller hands over numpy arrays (this module never imports JAX):

  * `params`: one array per `model.named_parameters()` name, e.g.
    "bottom_mlp.layers.0.kernel", "dcn_layers.1.down_proj_kernel",
    "small_embeddings.cat_3.embeddings". Dense and FeatureCross kernels
    keep the JAX [in, out] layout on both sides (the port computes
    x @ kernel), so they copy without a transpose.
  * `tables`: logical [vocab, dim] embedding tables by table name, as
    `DistributedEmbedding.get_embedding_tables` exports them; they go in
    through `set_embedding_tables`. Optimizer slots are not copied: both
    packages start the Adagrad accumulators at 0.1.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)


@torch.no_grad()
def load_params(
    model: nn.Module,
    params: Mapping[str, np.ndarray],
    tables: Mapping[str, np.ndarray] | None = None,
) -> None:
    """Copies `params` into every named parameter of `model` (all must be
    given, with matching shapes) and `tables` into the model's
    DistributedEmbedding layers."""
    named = dict(model.named_parameters())
    missing = set(named) - set(params)
    unknown = set(params) - set(named)
    if missing or unknown:
        raise ValueError(
            f"Parameter names differ: missing {sorted(missing)}, unknown "
            f"{sorted(unknown)}."
        )
    for name, p in named.items():
        value = torch.from_numpy(np.array(params[name]))
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: expected shape {tuple(p.shape)}, got "
                f"{tuple(value.shape)}."
            )
        p.copy_(value)
    if tables:
        layers = [
            m for m in model.modules() if isinstance(m, DistributedEmbedding)
        ]
        known = {
            t.name for layer in layers for s in layer.stacks for t in s.tables
        } | {name for layer in layers for name in layer.dense_tables}
        if set(tables) - known:
            raise ValueError(
                f"Unknown tables: {sorted(set(tables) - known)}."
            )
        for layer in layers:
            layer.set_embedding_tables(tables)
