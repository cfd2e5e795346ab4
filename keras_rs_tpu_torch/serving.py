"""Serving: fixed-shape captured callables and exported artifacts.

Counterpart of keras_rs_tpu/serving.py:

  * `aot_compile(fn, *example_args)`: a fixed-shape callable with no
    Python on the hot path. On CUDA tensors it captures `fn` once in a
    `torch.cuda.CUDAGraph` (after a warm-up on a side stream) over static
    input buffers; a call copies its arguments into them, replays the
    graph and returns clones of the outputs, so the request costs device
    execution only. A call whose structure, shapes, dtypes or devices
    differ from the example's raises ValueError. A host read inside `fn`
    (`.item()`, a data-dependent shape) fails the capture: there is no
    eager fallback. On CPU tensors it checks the same and calls `fn`.
  * `export_fn` / `import_fn`: `torch.export` of `fn` at the example
    shapes, saved to bytes, loaded back as a callable without the model
    code. The modules `fn` reaches (an `nn.Module` itself, or those bound
    in its closure) are registered in the exported wrapper, so their
    tables, int8 ones included, travel as buffers; other tensors it reads
    travel as constants.
  * `make_retrieval_service(query_fn, retrieval_layer)`: raw query
    features -> (scores, ids) in one function, to export.

Both forms run `fn` under `torch.no_grad()`. Inputs cross them as tensors
only: densify Ragged ids (`Ragged.to_padded(max_length=valence)`, a static
width) and move arrays to tensors before the call.

    service = make_retrieval_service(query_tower, retrieval_layer)
    blob = export_fn(service, example_queries)    # ship this
    serve = import_fn(blob)                       # in the server
    scores, ids = serve(queries)
"""

from __future__ import annotations

import functools
import io
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import _pytree as pytree

from keras_rs_tpu_torch.utils import cuda_graph

#: Runs of `fn` on a side stream before the capture (lazy allocations,
#: library handles and workspaces must exist before capture).
WARMUP_RUNS = 2


def _signature(leaf: Any) -> tuple:
    if not isinstance(leaf, torch.Tensor) and hasattr(leaf, "__array__"):
        raise ValueError(
            f"aot_compile takes tensors, not {type(leaf).__name__}: "
            "densify Ragged ids (to_padded(max_length=...)) and move "
            "arrays to tensors first."
        )
    return cuda_graph.leaf_signature(leaf)


class CompiledFn:
    """The callable `aot_compile` returns (utils/cuda_graph.py's Graph on
    CUDA tensors)."""

    def __init__(self, fn: Callable, example_args: tuple) -> None:
        leaves, self._spec = pytree.tree_flatten(example_args)
        self._signatures = [_signature(x) for x in leaves]
        self._fn = fn
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        on_cuda = {t.is_cuda for t in tensors}
        if len(on_cuda) > 1:
            raise ValueError("aot_compile: example tensors on CUDA and CPU.")
        self.graph: cuda_graph.Graph | None = None
        if on_cuda == {True}:
            side = torch.cuda.Stream()
            args = pytree.tree_unflatten(leaves, self._spec)
            for _ in range(WARMUP_RUNS):
                cuda_graph.run_on(side, self._call, args)
            self.graph = cuda_graph.Graph(self._call, leaves, self._spec,
                                          side)

    def _call(self, args: tuple) -> Any:
        with torch.no_grad():
            return self._fn(*args)

    def __call__(self, *args: Any) -> Any:
        leaves, spec = pytree.tree_flatten(args)
        if spec != self._spec:
            raise ValueError(
                f"aot_compile: argument structure {spec} differs from the "
                f"example's {self._spec}."
            )
        for i, (leaf, want) in enumerate(zip(leaves, self._signatures)):
            got = _signature(leaf)
            if got != want:
                raise ValueError(
                    f"aot_compile: argument leaf {i} is {got[1:]}, compiled "
                    f"for {want[1:]}."
                )
        if self.graph is None:
            return self._call(args)
        return self.graph(leaves)


def aot_compile(fn: Callable, *example_args: Any) -> CompiledFn:
    """`fn` fixed at the example arguments' structure, shapes and dtypes
    (captured as a CUDA graph on CUDA tensors); raises ValueError on a
    call that differs instead of running anything else."""
    return CompiledFn(fn, example_args)


def _modules_of(fn: Any, found: dict, seen: set) -> None:
    """Collects the nn.Modules `fn` is, is bound to, or closes over
    (through nested functions, partials, default arguments)."""
    if id(fn) in seen:
        return
    seen.add(id(fn))
    if isinstance(fn, nn.Module):
        found.setdefault(id(fn), fn)
        return
    if isinstance(fn, functools.partial):
        for x in (fn.func, *fn.args, *fn.keywords.values()):
            _modules_of(x, found, seen)
        return
    if hasattr(fn, "__self__"):
        _modules_of(fn.__self__, found, seen)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            _modules_of(cell.cell_contents, found, seen)
        except ValueError:  # an empty cell
            pass
    for x in getattr(fn, "__defaults__", None) or ():
        _modules_of(x, found, seen)


class _Exported(nn.Module):
    """`fn` as a module, with the modules it reaches as submodules."""

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        found: dict = {}
        _modules_of(fn, found, set())
        self.reached = nn.ModuleList(found.values())
        self._fn = fn

    def forward(self, *args: Any) -> Any:
        return self._fn(*args)


def export_fn(fn: Callable, *example_args: Any) -> bytes:
    """Serializes `fn` at the example shapes to a portable artifact (a
    saved `torch.export` program, tables included)."""
    module = fn if isinstance(fn, nn.Module) else _Exported(fn)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def import_fn(blob: bytes) -> Callable:
    """Loads an artifact produced by `export_fn`; returns a callable."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def serve(*args: Any) -> Any:
        with torch.no_grad():
            return module(*args)

    return serve


def make_retrieval_service(
    query_fn: Callable, retrieval_layer: Any
) -> Callable:
    """One function: raw query features -> (scores, ids).

    `query_fn` maps input features to [B, D] query embeddings;
    `retrieval_layer` is a built BruteForce/KMeans retrieval layer whose
    candidates are baked into the artifact at export time.
    """

    def service(inputs):
        return retrieval_layer(query_fn(inputs))

    return service
