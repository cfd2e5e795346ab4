"""The device a module of the port is built on.

The port runs on the card: a constructor given no `device` builds on
`cuda:0`. Where CUDA is absent it raises instead of moving to the CPU, so
a CPU run is always one that the caller asked for with `device="cpu"`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve_device(device: Any = None) -> torch.device:
    """`None` -> `cuda:0` (raises where CUDA is unavailable); anything
    else -> `torch.device(device)`."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device: keras_rs_tpu_torch builds on cuda:0 by "
            "default. Pass device='cpu' to run on the CPU."
        )
    return torch.device("cuda", 0)


def to_device(array: Any, device: Any) -> torch.Tensor:
    """A host array as a tensor on `device`. To a CUDA device it goes
    through pinned memory without waiting for the copy (the caching host
    allocator keeps the pinned block until the copy is done); on the CPU
    the tensor shares the array's memory. Call it from the thread that
    owns the device work, not from a loader thread."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
