"""The device a module of the port is built on.

The port runs on the card: a constructor given no `device` builds on
`cuda:0`. Where CUDA is absent it raises instead of moving to the CPU, so
a CPU run is always one that the caller asked for with `device="cpu"`.
"""

from __future__ import annotations

from typing import Any

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
