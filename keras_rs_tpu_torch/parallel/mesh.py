"""Meshes of ranks and the batch and table sharding over them.

Counterpart of keras_rs_tpu/parallel/mesh.py in PyTorch's idiom: one
process (rank) per device, `torch.distributed`, and the same program in
every rank. Where the JAX package builds one `jax.sharding.Mesh` over
all devices and shards arrays over its axes, a rank here holds its own
part: its rows of every batch (`put_batch`), its shard of every table
(layers/embedding/stacking.py) and a replica of the dense model. A mesh
names the axes (`init_device_mesh` with `mesh_dim_names`); the
collectives of an axis run over its process group (`Mesh.group`).

A tuple of every axis name shards over their flattened product, in mesh
order (parity with tests/test_2d_mesh.py): shard index
`coord[a0] * size[a1] + coord[a1]` for ("a0", "a1"). A mesh spans every
rank of the default process group.

Without an initialized process group the mesh has one rank, every axis
has size 1 and every group is None, so the one-device code paths run
unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.utils.device import resolve_device, to_device

DATA_AXIS = "data"

AxisName = str | tuple[str, ...]


class Mesh:
    """Named axes over the ranks of the default process group (or over
    this process alone), and this rank's device."""

    def __init__(self, axis_names: tuple[str, ...],
                 axis_sizes: tuple[int, ...], device: torch.device,
                 device_mesh: Any = None) -> None:
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, axis_sizes))
        self.device = device
        #: torch.distributed.device_mesh.DeviceMesh, None for one rank.
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def _axes(self, axis_name: AxisName) -> tuple[str, ...]:
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"Unknown mesh axes {unknown}; the mesh has "
                             f"{self.axis_names}.")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"Axes {axes} must be in mesh order "
                             f"{self.axis_names}.")
        return axes

    def group(self, axis_name: AxisName):
        """The process group of the ranks along `axis_name` that holds
        this rank (a tuple of every axis: all ranks); None where the axes
        span one rank. Every rank must call it at the same point of the
        program the first time (a mesh dimension's group is made
        collectively)."""
        axes = self._axes(axis_name)
        if self.device_mesh is None or axis_size(self, axes) == 1:
            return None
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        if len(axes) > 1:
            raise ValueError(f"A tuple of axes names every axis of the "
                             f"mesh {self.axis_names}; got {axes}.")
        return self.device_mesh.get_group(axes[0])

    def index(self, axis_name: AxisName) -> int:
        """This rank's shard index along `axis_name` (0 for one rank)."""
        axes = self._axes(axis_name)
        if self.device_mesh is None:
            return 0
        coord = self.device_mesh.get_coordinate()
        out = 0
        for a in axes:
            i = self.axis_names.index(a)
            out = out * self.shape[a] + coord[i]
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def create_mesh(device: Any = None, axis_name: AxisName = DATA_AXIS,
                axis_sizes: tuple[int, ...] | None = None) -> Mesh:
    """A mesh over every rank of the default process group, or over this
    process alone where none is initialized. A tuple `axis_name` builds
    an N-D mesh of `axis_sizes` (by default every rank on the first
    axis). `device` is this rank's device (default cuda:0,
    utils/device.py); a CUDA device becomes the current device before
    the mesh is built, so the mesh keeps it."""
    device = resolve_device(device)
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(names):
        raise ValueError(f"{len(axis_sizes)} sizes for axes {names}.")
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"Mesh {dict(zip(names, axis_sizes))} for "
                         f"{world} ranks.")
    if world == 1:
        return Mesh(names, axis_sizes, device)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    device_mesh = init_device_mesh(device.type, axis_sizes,
                                   mesh_dim_names=names)
    return Mesh(names, axis_sizes, device, device_mesh)


def axis_size(mesh: Mesh, axis_name: AxisName) -> int:
    """Number of shards along `axis_name` (product for tuples)."""
    axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def batch_rows(mesh: Mesh, n: int, axis_name: AxisName = DATA_AXIS
               ) -> slice:
    """This rank's rows of a dim-0 extent `n` sharded over `axis_name`
    (the JAX package's batch_sharding)."""
    D = axis_size(mesh, axis_name)
    if n % D:
        raise ValueError(f"{n} rows do not split over {D} shards.")
    r = mesh.index(axis_name)
    return slice(r * (n // D), (r + 1) * (n // D))


def put_batch(mesh: Mesh, batch: Any,
              axis_name: AxisName = DATA_AXIS) -> Any:
    """This rank's rows of dim 0 of every leaf of a host batch (dict,
    list or array), as tensors on the mesh's device."""
    if isinstance(batch, dict):
        return {k: put_batch(mesh, v, axis_name) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(put_batch(mesh, v, axis_name) for v in batch)
    a = np.asarray(batch)
    return to_device(a[batch_rows(mesh, a.shape[0], axis_name)],
                     mesh.device)


def replicate(mesh: Mesh, tree: Any,
              axis_name: AxisName = DATA_AXIS) -> Any:
    """Every tensor of `tree` (dict / list / tuple) overwritten in place
    with rank 0's values along `axis_name` (a broadcast); returns
    `tree`."""
    group = mesh.group(axis_name)
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            collectives.broadcast(tree, group)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v, axis_name)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(mesh, v, axis_name)
    return tree
