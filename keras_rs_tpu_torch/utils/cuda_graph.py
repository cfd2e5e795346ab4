"""A function captured as a CUDA graph over static inputs, and replayed.

The mechanism of `serving.aot_compile` and of the one-card training step
(training/train_state.StepGraph); they differ only in what a call that
does not match the capture does (serving raises, the training step runs
eagerly):

    leaves, spec = pytree.tree_flatten(args)
    key = [leaf_signature(x) for x in leaves]  # what a replay must match
    run_on(stream, fn, args)                   # a warm-up on a side stream
    graph = Graph(fn, leaves, spec, stream)    # fn(args), captured
    out = graph(leaves)                        # copy in, replay, clones

`fn` takes the one argument `args` rebuilt from the leaves.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

#: Leaves a signature keeps by value.
SCALARS = (bool, int, float, str, type(None))


def leaf_signature(leaf: Any) -> tuple:
    """A tensor's ("tensor", shape, dtype, device), a plain value's
    ("value", type, value), any other object's ("object", id)."""
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, SCALARS):
        return ("value", type(leaf), leaf)
    return ("object", id(leaf))


def run_on(stream: torch.cuda.Stream, fn: Callable[[Any], Any],
           args: Any) -> Any:
    """`fn(args)` on `stream`, after the work queued on the current stream,
    which then waits for it: the run that lazy allocations, library
    handles and workspaces need before a capture on `stream`."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn(args)
    current.wait_stream(stream)
    return out


class Graph:
    """`fn(args)` captured on `stream` as a CUDA graph, over clones of the
    tensor leaves (`inputs`; `args` is `spec` rebuilt from them). Calling
    it with leaves of the same signature copies their tensors into the
    clones, replays, and returns clones of the outputs, tensors of their
    own on every call. The capture synchronizes the device once, outside
    any sync-debug mode; it raises what `fn` raised, a host read say."""

    def __init__(self, fn: Callable[[Any], Any], leaves: list, spec: Any,
                 stream: torch.cuda.Stream) -> None:
        self.inputs = [x.clone() if isinstance(x, torch.Tensor) else x
                       for x in leaves]
        self.graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn(pytree.tree_unflatten(self.inputs, spec))
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def __call__(self, leaves: list) -> Any:
        for static, leaf in zip(self.inputs, leaves):
            if isinstance(leaf, torch.Tensor):
                static.copy_(leaf)
        self.graph.replay()
        return pytree.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            self.out)
