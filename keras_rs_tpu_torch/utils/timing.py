"""Device time of a training step, from CUDA events.

Counterpart of the contract of keras_rs_tpu/utils/timing.py's
`measure_step_time`: the median device time per step over blocks of
chained steps. The steps of a block are enqueued back to back on the
current stream (each updates the state the next one reads, as a training
loop does), bracketed by two CUDA events, and the block's time is read
once after a synchronize, so the host's work between steps adds nothing
unless it holds the device back. (The JAX package chains its steps in one
jitted scan because its TPU runtime's block call returned early; a CUDA
event needs no such detour.)
"""

from __future__ import annotations

import statistics
from typing import Any, Callable

import torch


def measure_step_time(step: Callable[[Any], Any], batch: Any,
                      iters: int = 20, blocks: int = 3) -> float:
    """Median seconds per `step(batch)` on the CUDA device, over `blocks`
    blocks of `iters` chained calls after one warm-up block. The steps
    update the model: time on a model whose training may go on. Raises
    without a CUDA device (a CPU time is not a device time)."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_time needs a CUDA device.")
    times = []
    for block in range(blocks + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step(batch)
        end.record()
        torch.cuda.synchronize()
        if block:  # block 0 warms up
            times.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(times)
