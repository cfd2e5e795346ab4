"""What one run hands the per-layer metric readers (`metrics/<name>.py`,
each `read(run) -> float | None`)."""

from __future__ import annotations

import dataclasses

from benchmark.trace import Trace


@dataclasses.dataclass
class RunRecord:
    config: dict
    traffic: dict
    #: Steps timed without the profiler, and their host-clock seconds
    #: (the last step's completion included).
    steps: int
    wall_s: float
    #: Host seconds of each unprofiled step's `train_step` call (the
    #: enqueue: no synchronize) and of each `next(loader)` before it.
    enqueue_s: list[float]
    wait_s: list[float]
    #: The profiled stretch (None without --trace 1) and the raw batches
    #: its steps took, in order.
    trace: Trace | None = None
    profiled_batches: list[dict] | None = None
