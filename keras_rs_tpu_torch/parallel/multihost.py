"""Multi-process helpers (counterpart of keras_rs_tpu/parallel/multihost.py).

One process per device, joined by `torch.distributed`. `initialize`
starts the process group from the launcher's environment (torchrun sets
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT) or from explicit
arguments; the backend is named, never switched: NCCL for a CUDA device
(cuda:0 when no device is given, as everywhere in the port) unless the
caller names another (gloo carries two ranks on one card), gloo for the
CPU. On one process every helper is the identity, so the same script
runs on one device and on several.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.parallel.mesh import DATA_AXIS
from keras_rs_tpu_torch.utils.device import resolve_device, to_device


def default_backend(device: Any = None) -> str:
    """NCCL for a CUDA device, gloo otherwise; `device` None is cuda:0
    (resolve_device: raises where CUDA is unavailable)."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(device: Any = None, backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> bool:
    """Starts the default process group where more than one process
    runs (WORLD_SIZE > 1 or `world_size` > 1) and none exists yet;
    returns whether one is initialized afterwards. `backend` defaults to
    `default_backend(device)`; `init_method` to "env://"."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend=backend or default_backend(device),
        init_method=init_method or "env://",
        rank=rank,
        world_size=world_size,
    )
    return True


def rank_device(device: Any = None) -> torch.device:
    """This process's device: `device` where given, else cuda:LOCAL_RANK
    under a launcher with more than one process, else cuda:0
    (utils/device.py). A CUDA device that does not exist raises."""
    if device is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         "0")))
    device = resolve_device(device)
    if device.type == "cuda" and not (
            torch.cuda.is_available()
            and (device.index or 0) < torch.cuda.device_count()):
        raise RuntimeError(
            f"{device} does not exist on this machine "
            f"({torch.cuda.device_count()} CUDA device(s)); name another "
            "with --device."
        )
    return device


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a small host value crosses the default group: the current
    CUDA device under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x: Any) -> np.ndarray:
    """[P, ...]: every process's value of the numeric array `x`."""
    a = np.asarray(x)
    if not dist.is_initialized():
        return a[None]
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_collective_device())
    out = collectives.all_gather(t[None], dist.group.WORLD)
    return out.cpu().numpy()


#: Stats that add across processes (each process drops its own ids);
#: the others merge by max (capacities are per-shard maxima).
_SUM_STATS = frozenset({"dropped_ids"})


def sync_max_stats(stats: dict[str, int],
                   sum_keys: frozenset[str] = _SUM_STATS) -> dict[str, int]:
    """Merges integer stats across processes (update_stats parity): max
    for capacity watermarks, sum for additive counters such as
    `dropped_ids`. One all_reduce of an int64 tensor with MAX and one
    with SUM; the identity on one process."""
    if not dist.is_initialized():
        return {k: int(v) for k, v in stats.items()}
    keys = sorted(stats)
    dev = _collective_device()
    values = torch.tensor([int(stats[k]) for k in keys], dtype=torch.int64,
                          device=dev)
    group = dist.group.WORLD
    merged_max = collectives.all_reduce(values.clone(), group, "max")
    merged_sum = collectives.all_reduce(values.clone(), group, "sum")
    return {
        k: int(merged_sum[i] if k in sum_keys else merged_max[i])
        for i, k in enumerate(keys)
    }


def global_batch_from_host_shards(mesh: Any, batch: Any,
                                  axis_name: Any = DATA_AXIS) -> Any:
    """Each process passes its rows of the global batch (as
    CriteoDataset(process_index=..., process_count=...) yields them),
    sharded over `axis_name` (an axis of `mesh`, or a tuple of its axes;
    another name raises ValueError); they stay this rank's rows, moved
    to the mesh's device: a rank computes on its own rows, so nothing is
    assembled."""
    mesh._axes(axis_name)  # raises for a name the mesh does not have
    if isinstance(batch, dict):
        return {k: global_batch_from_host_shards(mesh, v, axis_name)
                for k, v in batch.items()}
    return to_device(np.asarray(batch), mesh.device)
