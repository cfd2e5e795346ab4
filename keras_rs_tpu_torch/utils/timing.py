"""Device time of a training step, from CUDA events; the H100's peak
rates, the device time of a torch.profiler trace and the card's name
and power limit, which the scripts that time the port print beside their
numbers.

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
import subprocess
from typing import Any, Callable

import torch

# H100 SXM published peaks: HBM bytes/s, and FLOP/s by input type. bf16
# runs on the tensor cores at 989 TFLOP/s. f32 inputs: the flash kernels
# run each product as three TF32 tensor-core products (big*big +
# big*small + small*big, to stay within 1e-5 of f32 math), so their rate
# is the TF32 peak over three, 495 / 3 = 165 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


def measure_step_time(step: Callable[[Any], Any], batch: Any,
                      iters: int = 20, blocks: int = 3) -> float:
    """Median seconds per `step(batch)` on the CUDA device, over `blocks`
    blocks of `iters` chained calls after one warm-up block. The steps
    update the model: time on a model whose training may go on. Raises
    without a CUDA device (a CPU time is not a device time)."""
    return measure_step_times([(step, batch)], iters, blocks)[0]


def measure_step_times(runs: list[tuple[Callable[[Any], Any], Any]],
                       iters: int = 20, blocks: int = 3) -> list[float]:
    """`measure_step_time` of each (step, batch) of `runs`, their blocks
    taken in turn: one block of each run, `blocks` times after one
    warm-up round. Where the host paces the steps, its speed drifts
    between blocks, so runs that are compared with each other meet the
    same host this way."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_time needs a CUDA device.")
    times: list[list[float]] = [[] for _ in runs]
    for block in range(blocks + 1):
        for run_times, (step, batch) in zip(times, runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step(batch)
            end.record()
            torch.cuda.synchronize()
            if block:  # round 0 warms up
                run_times.append(start.elapsed_time(end) / 1e3 / iters)
    return [statistics.median(t) for t in times]


def device_ms(avgs) -> float:
    """The device time (ms) of a torch.profiler trace's kernel and copy
    rows, from its `key_averages()`."""
    cpu = torch.autograd.DeviceType.CPU
    # Operator rows also carry the device time of the kernels they
    # launch: only the kernel rows are summed for the total. A labelled
    # range (record_function) has a CPU row and a device-timeline twin of
    # the same name, which spans the range's kernels and the gaps between
    # them: the twin is no kernel.
    cpu_keys = {e.key for e in avgs if e.device_type == cpu}
    return sum(e.self_device_time_total for e in avgs
               if e.device_type != cpu and e.key not in cpu_keys) / 1e3


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
