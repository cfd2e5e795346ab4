"""Meshes, collectives and multi-process helpers (counterpart of
keras_rs_tpu/parallel). The JAX package's ShardedBruteForceRetrieval is
not ported yet (ROADMAP A10)."""

from keras_rs_tpu_torch.parallel import collectives, multihost
from keras_rs_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    axis_size,
    batch_rows,
    create_mesh,
    put_batch,
    replicate,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "axis_size",
    "batch_rows",
    "collectives",
    "create_mesh",
    "multihost",
    "put_batch",
    "replicate",
]
