"""Meshes, collectives, multi-process helpers, row-sharded exact
retrieval and the multi-rank dry run (counterpart of
keras_rs_tpu/parallel and of __graft_entry__.dryrun_multichip)."""

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
from keras_rs_tpu_torch.parallel.sharded_retrieval import (
    ShardedBruteForceRetrieval,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "ShardedBruteForceRetrieval",
    "axis_size",
    "batch_rows",
    "collectives",
    "create_mesh",
    "multihost",
    "put_batch",
    "replicate",
]
