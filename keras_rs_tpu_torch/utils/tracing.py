"""Spans and counters of the training step, off unless `enable()` is
called.

A span is a named stretch of host time at a layer boundary of the step:

    with tracing.span("embedding.update", stack=stack.name):
        ...

Off (the default), `span` checks one module flag and returns one shared
null context: no record, no torch call. On, each span keeps (name, step
id, id, parent id, thread id, start and end from `time.perf_counter_ns`,
attrs) in a bounded buffer (`spans()`); the oldest records go first when
it is full. The span named `step` (training/train_state.make_train_step)
is the root of one training step and gives every span inside it the
step's id. A span's parent is the innermost span open on its thread,
else, on a thread with none open (autograd's device thread, which runs
the lookup's backward), the innermost span open on the thread of the
open step. Spans outside a step have step id None.

Under an active torch.profiler a span that is on also opens
`torch.profiler.record_function(name)`, so the profiler's Chrome trace
holds it as a `user_annotation` range on the device trace's own clock
(examples/ml_perf/main.py's `--profile` writes that trace).

`count(name, value)` sums a counter while tracing is on: a host int adds
on the host, a one-element integer tensor adds on its device into an
int64 accumulator with no host read. `counters()` reads them all, with
one synchronisation per device.

A step replayed as a CUDA graph (train_state.py) runs none of its Python,
so its inner spans are not recorded: it has the spans `step` and
`step.replay`. Its host-int counters add what the capture counted, its
device counters add on the device as captured, and a `reset()` makes
the next steps capture anew into the new counters.

The spans and counters of the port:

    step                       the training step (train_state.py)
    step.forward / .backward / .optimizer
                               the loss, its backward, the dense optimizer
                               (eager and capturing calls)
    step.replay                the copy of the batch into the graph's
                               inputs and the graph's launch
    step.graph_captures        counter: captures of the step's graph
    step.graph_replays         counter: steps run as a replay, the
                               capturing call's own included
    step.graph_eager           counter: steps on a CUDA device at D = 1
                               that ran eagerly
    embedding.coo              the device COO transform, per stack and
                               around the whole batch (distributed_embedding)
    embedding.lookup           a stack's lookup forward (lookup.py)
    embedding.update           a stack's update in the backward (lookup.py)
    host_sync                  a read of a device value on the host (attr site)
    loader.to_device           the loader's move of a batch to the device
    collective.all_to_all / .reduce_scatter / .all_gather / .all_reduce
    / .broadcast               one collective of a group of more than one
                               rank (parallel/collectives.py; attr bytes)
    embedding.ids              counter: id entries of the device COO
    embedding.unique_rows      counter: unique rows the update writes
    embedding.dropped_ids      counter: ids the device COO dropped
    collective.<kind>_bytes    counter: the bytes of that kind's
                               collectives, as count_bytes counts them
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, NamedTuple

import torch

#: Name of the root span of one training step.
STEP = "step"
#: Records the buffer holds before it drops the oldest.
CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    #: The id of the training step the span belongs to (None outside one).
    step: int | None
    id: int
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict[str, Any]


class _Null:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()
_on = False
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count()
_steps = itertools.count()
_local = threading.local()
#: The open-span stack of the thread that runs the open step, or None.
_step_stack: list | None = None
_lock = threading.Lock()
_host_counts: dict[str, int] = {}
_device_counts: dict[str, torch.Tensor] = {}
_generation = 0


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "step", "stack",
                 "outer_step_stack", "record", "start")

    def __init__(self, name: str, attrs: dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        global _step_stack
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            parent = stack[-1]
        elif _step_stack and self.name != STEP:
            parent = _step_stack[-1]
        else:
            parent = None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if self.name == STEP:
            self.step = next(_steps)
            self.outer_step_stack = _step_stack
            _step_stack = stack
        else:
            self.step = None if parent is None else parent.step
        self.stack = stack
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _step_stack
        end = time.perf_counter_ns()
        self.stack.pop()
        if self.record is not None:
            self.record.__exit__(None, None, None)
        if self.name == STEP:
            _step_stack = self.outer_step_stack
        _records.append(Span(self.name, self.step, self.id, self.parent,
                             threading.get_ident(), self.start, end,
                             self.attrs))
        return False


def span(name: str, **attrs: Any):
    """A context manager timing `name` while tracing is on; the shared
    null context while it is off."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def count(name: str, value: int | torch.Tensor) -> None:
    """Adds `value` to the counter `name` while tracing is on: a host int
    on the host, a one-element integer tensor on its device (no host
    read)."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        v = value.detach().reshape(())
        with _lock:
            acc = _device_counts.get(name)
            if acc is None:
                _device_counts[name] = v.to(torch.int64, copy=True)
            else:
                acc.add_(v)
        return
    with _lock:
        _host_counts[name] = _host_counts.get(name, 0) + int(value)


def counters() -> dict[str, int]:
    """Every counter's sum since the last `reset()`: the device ones read
    in one transfer per device."""
    with _lock:
        out = dict(_host_counts)
        device = dict(_device_counts)
    by_device: dict[torch.device, list[str]] = collections.defaultdict(list)
    for name, acc in device.items():
        by_device[acc.device].append(name)
    for names in by_device.values():
        values = torch.stack([device[n] for n in names]).tolist()
        for n, v in zip(names, values):
            out[n] = out.get(n, 0) + v
    return out


def host_counts() -> dict[str, int]:
    """The counters that add on the host (host ints), as they stand: no
    device read."""
    with _lock:
        return dict(_host_counts)


def generation() -> int:
    """How many times `reset()` has run: a CUDA graph of the step
    (train_state.py) replays only into the counters it was captured
    with."""
    return _generation


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def spans() -> list[Span]:
    """The recorded spans, in the order they closed."""
    return list(_records)


def reset() -> None:
    """Drops the recorded spans and counters and restarts the step ids."""
    global _steps, _generation
    with _lock:
        _records.clear()
        _host_counts.clear()
        _device_counts.clear()
        _steps = itertools.count()
        _generation += 1
