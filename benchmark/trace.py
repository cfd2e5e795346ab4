"""Reduces a torch.profiler trace of the profiled steps to what the
per-layer metrics and the breakdown read: the device's operations
(kernels, copies, fills) with their times, the union of their intervals
(the device's busy time), and the longest gaps between them, each named
by what the host was doing meanwhile.

The trace is the profiler's Chrome trace (its documented export), written
to the process's temporary directory, read and deleted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
SPAN_PREFIX = "bench."
TOP = 10


@dataclasses.dataclass
class Trace:
    #: (name, start_us, dur_us) of every device operation.
    ops: list[tuple[str, float, float]]
    #: Seconds in which some device operation ran.
    busy_s: float
    #: Host-clock length of the profiled stretch and its steps.
    window_s: float
    steps: int
    #: (label, seconds) of the longest idle gaps.
    gaps: list[tuple[str, float]]

    def seconds_of(self, fragment: str) -> float | None:
        """Device seconds of the operations whose name holds `fragment`
        (None where none ran)."""
        times = [d for n, _, d in self.ops if fragment in n]
        return sum(times) / 1e6 if times else None

    def top_ops(self) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for n, _, d in self.ops:
            total[n] += d / 1e6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def _union(intervals: list[tuple[float, float]]
           ) -> tuple[float, list[tuple[float, float]]]:
    """(covered length, gaps) of intervals [start, end)."""
    covered, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            covered += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered, gaps


def _label(host: list[dict], at: float) -> str:
    """The benchmark's span and the innermost host operation running at
    `at` (microseconds)."""
    span, inner, inner_ts = "outside the step", "idle host", -1.0
    for ev in host:
        if ev["ts"] <= at < ev["ts"] + ev.get("dur", 0.0):
            if ev["name"].startswith(SPAN_PREFIX):
                span = ev["name"][len(SPAN_PREFIX):]
            elif ev["ts"] > inner_ts:
                inner, inner_ts = ev["name"], ev["ts"]
    return f"{span}: {inner}"


def reduce(events: list[dict], window_s: float, steps: int) -> Trace:
    """The Trace of Chrome-trace `events` over `steps` profiled steps."""
    ops = [(ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0)))
           for ev in events
           if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS]
    covered, gaps = _union([(s, s + d) for _, s, d in ops])
    host = [ev for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in HOST_CATS]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return Trace(
        ops=ops, busy_s=covered / 1e6, window_s=window_s, steps=steps,
        gaps=[(_label(host, (s + e) / 2.0), (e - s) / 1e6)
              for s, e in longest],
    )


def from_profiler(prof, window_s: float, steps: int) -> Trace:
    """Exports `prof`'s trace under TMPDIR, reduces it and deletes it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, window_s, steps)
