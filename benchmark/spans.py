"""Per-layer host and device time of the port's training step, read from
the port's own spans and counters (keras_rs_tpu_torch/utils/tracing.py).

Two reductions, both of what the port records and nothing of how it
computes:

  self_times(spans)    host: each span's duration less the part of it
                       that its child spans cover, summed by name;
  DeviceTimes(events)  device: a torch.profiler Chrome trace whose
                       `user_annotation` ranges are the spans (tracing on
                       under the profiler). Each kernel, copy and fill
                       belongs to the innermost range that was open on
                       the thread that launched it (matched through the
                       launch's `correlation`), or, on a thread with none
                       open (autograd's device thread), to the innermost
                       range open on the step's thread at the launch. The
                       longest idle gaps of the device are named by the
                       innermost range open at their middle.

`metrics` turns both, with the counters, into the per-layer metrics,
in ms per step summed over stacks:

  coo_host_ms, coo_device_ms              embedding.coo
  lookup_host_ms, lookup_device_ms        embedding.lookup
  dense_host_ms, dense_device_ms          self time of step.forward and
                                          step.backward
  update_host_ms, update_device_ms        embedding.update
  optimizer_host_ms, optimizer_device_ms  step.optimizer
  host_sync_ms                            host_sync
  to_device_ms                            loader.to_device
  unique_row_share                        embedding.unique_rows / embedding.ids

Run as a module it sets a cell up as run.py does, runs a window with
tracing off, a window with tracing on (stretch a: host times, counters)
and PROFILED_STEPS steps with tracing on under the profiler (stretch b:
device times), and prints one JSON line; with --sync_debug, one more
step under `torch.cuda.set_sync_debug_mode("warn")`:

  python3 -m benchmark.spans --workload dlrm-packed.multihot \\
      --seed 2147483911 --seconds 5 [--sync_debug]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from typing import Any, Iterable

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
STEP = "step"
#: Layer -> the span names whose self time it sums.
LAYERS = {
    "coo": ("embedding.coo",),
    "lookup": ("embedding.lookup",),
    "dense": ("step.forward", "step.backward"),
    "update": ("embedding.update",),
    "optimizer": ("step.optimizer",),
    "host_sync": ("host_sync",),
    "to_device": ("loader.to_device",),
}
#: Layers with a device metric (host_sync and to_device have host ones).
DEVICE_LAYERS = ("coo", "lookup", "dense", "update", "optimizer")
#: Layers whose self times add up to the step's host time.
STEP_LAYERS = ("coo", "lookup", "dense", "update", "optimizer", "host_sync")
PROFILED_STEPS = 12
TOP = 10


def host_metric(layer: str) -> str:
    """The name of a layer's host metric."""
    return (f"{layer}_ms" if layer in ("host_sync", "to_device")
            else f"{layer}_host_ms")


def _covered(start: float, end: float,
             intervals: Iterable[tuple[float, float]]) -> float:
    """Length of [start, end) that the union of `intervals` covers."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, start), min(e, end)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def self_times(spans: Iterable[Any]) -> dict[str, int]:
    """Nanoseconds of self time by span name: each span's duration less
    the part of it its children (spans whose parent it is, on any thread)
    cover. `spans` are tracing.Span records (or anything with their
    fields)."""
    spans = list(spans)
    children: dict[int, list] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out: dict[str, int] = defaultdict(int)
    for s in spans:
        out[s.name] += (s.end_ns - s.start_ns) - int(_covered(
            s.start_ns, s.end_ns, children.get(s.id, ())))
    return dict(out)


def _innermost(ranges: list[tuple[float, float, str]], at: float
               ) -> str | None:
    """The name of the innermost range [start, end) holding `at`: the
    latest to start (the shorter on a tie)."""
    best = None
    for s, e, name in ranges:
        if s <= at < e and (best is None or (s, -e) > (best[0], -best[1])):
            best = (s, e, name)
    return None if best is None else best[2]


class DeviceTimes:
    """Device microseconds of a Chrome trace by the innermost span that
    launched them (`by_span`), what no span launched (`unattributed_us`),
    and the longest idle gaps between device operations, each named by
    the innermost span open at its middle (`gaps`, (name, us))."""

    def __init__(self, events: list[dict]) -> None:
        xs = [e for e in events if e.get("ph") == "X"]
        ranges: dict[Any, list] = defaultdict(list)
        step_tids = set()
        for e in xs:
            if e.get("cat") == "user_annotation":
                s = float(e["ts"])
                ranges[e["tid"]].append((s, s + float(e.get("dur", 0.0)),
                                         e["name"]))
                if e["name"] == STEP:
                    step_tids.add(e["tid"])
        launches = {}
        for e in xs:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[corr] = (e["tid"], float(e["ts"]))
        step_ranges = [r for t in step_tids for r in ranges[t]]
        ops = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.by_span: dict[str, float] = defaultdict(float)
        self.unattributed_us = 0.0
        self.total_us = 0.0
        for e in ops:
            dur = float(e.get("dur", 0.0))
            self.total_us += dur
            launch = launches.get(e.get("args", {}).get("correlation"))
            name = None
            if launch is not None:
                tid, ts = launch
                name = (_innermost(ranges.get(tid, []), ts)
                        or _innermost(step_ranges, ts))
            if name is None:
                self.unattributed_us += dur
            else:
                self.by_span[name] += dur
        self.by_span = dict(self.by_span)
        everything = [r for rs in ranges.values() for r in rs]
        intervals = sorted((float(e["ts"]), float(e["ts"])
                            + float(e.get("dur", 0.0))) for e in ops)
        gaps, cur_e = [], None
        for s, e in intervals:
            if cur_e is not None and s > cur_e:
                gaps.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        self.gaps = [(_innermost(everything, (s + e) / 2.0)
                      or "outside any span", e - s) for s, e in gaps[:TOP]]

    @property
    def coverage(self) -> float | None:
        """Share of the device time that some span launched."""
        if not self.total_us:
            return None
        return 1.0 - self.unattributed_us / self.total_us


def metrics(host_spans: list, steps: int, counters: dict[str, int],
            device: DeviceTimes | None = None, device_steps: int = 0
            ) -> dict[str, float]:
    """The per-layer metrics of a host stretch of `steps` steps (its spans
    and counters) and, where given, a profiled stretch of `device_steps`
    (its DeviceTimes). A layer whose spans did not run reads 0."""
    out: dict[str, float] = {}
    selfs = self_times(host_spans)
    for layer, names in LAYERS.items():
        out[host_metric(layer)] = sum(selfs.get(n, 0)
                                      for n in names) / 1e6 / steps
    if device is not None and device_steps:
        for layer in DEVICE_LAYERS:
            out[f"{layer}_device_ms"] = sum(
                device.by_span.get(n, 0.0)
                for n in LAYERS[layer]) / 1e3 / device_steps
    ids = counters.get("embedding.ids", 0)
    if ids:
        out["unique_row_share"] = counters.get(
            "embedding.unique_rows", 0) / ids
    return out


def trace_events(prof) -> list[dict]:
    """`prof`'s Chrome trace events, through a file under TMPDIR that is
    deleted again."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark-spans-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def span_ns(on: bool, n: int = 200_000) -> float:
    """Host nanoseconds one span costs, tracing on or off (no profiler),
    over an empty loop's."""
    from keras_rs_tpu_torch.utils import tracing

    was = tracing.enabled()
    (tracing.enable if on else tracing.disable)()
    try:
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        empty = time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("embedding.coo", stack="s"):
                pass
        spent = time.perf_counter_ns() - t
    finally:
        (tracing.enable if was else tracing.disable)()
        tracing.reset()
    return (spent - empty) / n


def _window(trainer, seconds: float, sync) -> tuple[int, list, list]:
    """(steps, enqueue seconds, next(loader) seconds) of a closed loop of
    `seconds`, as run.py's window."""
    enqueue, wait = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        batch = next(trainer.loader)
        b = time.perf_counter()
        trainer.step(batch)
        c = time.perf_counter()
        wait.append(b - a)
        enqueue.append(c - b)
        if c - t0 >= seconds:
            break
    sync()
    return len(enqueue), enqueue, wait


def measure(cell, seed: int, seconds: float, device,
            sync_debug: bool = False) -> dict:
    """Sets `cell` (spec.Cell) up on `device` as run.py does and measures
    it: a closed window of `seconds` with tracing off, one with tracing
    on (stretch a), PROFILED_STEPS steps with tracing on under the
    profiler (stretch b, CUDA only: a CPU run gives no device metric),
    and with `sync_debug` one step under the CUDA sync debug mode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import counts, run
    from keras_rs_tpu_torch.utils import tracing

    cuda = device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    config, mix = cell.config, cell.traffic
    port, _, traffic = cell.modules()
    pool = traffic.make_pool(config, mix, seed)
    run.log(f"pool of {len(pool)} batches")
    model = port.build(config, mix, seed, device)
    port.load_weights(model, config, seed)
    sync()
    run.log("model built, weights written")
    trainer = port.Trainer(model, config, pool)
    done = 0  # batches the loader handed over (one worker: pool order)
    for _ in range(5):
        trainer.step(next(trainer.loader))
        done += 1
    sync()
    run.log("warmed up")

    steps_off, enq_off, wait_off = _window(trainer, seconds, sync)
    done += steps_off
    first_on = done
    tracing.reset()
    tracing.enable()
    steps_on, enq_on, wait_on = _window(trainer, seconds, sync)
    tracing.disable()
    done += steps_on
    counters = tracing.counters()
    host_spans = tracing.spans()
    run.log(f"windows: {steps_off} steps off, {steps_on} on")
    # Each pool batch counted once (the window cycles through the pool).
    uses = defaultdict(int)
    for j in range(first_on, done):
        uses[j % len(pool)] += 1
    want_unique = sum(n * counts.unique_rows(config, pool[i])
                      for i, n in uses.items())
    run.log("unique rows of the traced batches counted")

    device_times = None
    if cuda:
        tracing.reset()
        tracing.enable()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_STEPS):
                trainer.step(next(trainer.loader))
            sync()
        tracing.disable()
        device_times = DeviceTimes(trace_events(prof))
        del prof
        run.log("profiled stretch reduced")

    out = metrics(host_spans, steps_on, counters, device_times,
                  PROFILED_STEPS)
    selfs = self_times(host_spans)
    result = {
        "metrics": out,
        "host_enqueue_ms_off": 1e3 * statistics.fmean(enq_off),
        "host_enqueue_ms_on": 1e3 * statistics.fmean(enq_on),
        "batch_wait_ms_off": 1e3 * statistics.fmean(wait_off),
        "batch_wait_ms_on": 1e3 * statistics.fmean(wait_on),
        "step_span_ms": sum(s.end_ns - s.start_ns for s in host_spans
                            if s.name == STEP) / 1e6 / steps_on,
        "step_layers_host_ms": sum(out[host_metric(k)]
                                   for k in STEP_LAYERS),
        "step_self_host_ms": selfs.get(STEP, 0) / 1e6 / steps_on,
        "spans_per_step": sum(s.step is not None
                              for s in host_spans) / steps_on,
        "counters": counters,
        "unique_rows_of_the_batches": want_unique,
        "span_ns_off": span_ns(False),
        "span_ns_on": span_ns(True),
    }
    if device_times is not None:
        result.update({
            "device_ms_by_span": {k: v / 1e3 / PROFILED_STEPS
                                  for k, v in device_times.by_span.items()},
            "device_ms_unattributed": (device_times.unattributed_us / 1e3
                                       / PROFILED_STEPS),
            "device_ms_total": device_times.total_us / 1e3 / PROFILED_STEPS,
            "device_coverage": device_times.coverage,
            "idle_gaps_ms": [[n, us / 1e3] for n, us in device_times.gaps],
        })
    if sync_debug and cuda:
        batch = next(trainer.loader)
        sync()
        tracing.reset()
        tracing.enable()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.step(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        tracing.disable()
        sync()
        # The mode's own notice that it is a prototype is no sync.
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        result["sync_debug"] = {
            "warnings": len(syncs),
            "messages": sorted({m[:120] for m in syncs}),
            "host_sync_spans": sum(s.name == "host_sync"
                                   for s in tracing.spans()),
        }
    tracing.reset()
    trainer.stop()
    return result


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--sync_debug", action="store_true")
    args = parser.parse_args(argv)
    from benchmark import run
    from benchmark.spec import load_cell

    run.cache_dirs(run.ROOT)
    cell = load_cell(args.workload, run.ROOT)
    import torch

    torch.set_num_threads(run.HOST_THREADS)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    run.log(f"{args.workload} seed {args.seed} on "
            f"{torch.cuda.get_device_name(0)}")
    result = measure(cell, args.seed, args.seconds, torch.device("cuda", 0),
                     args.sync_debug)
    result.update(workload=args.workload, seed=args.seed,
                  card=run.card_line())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
