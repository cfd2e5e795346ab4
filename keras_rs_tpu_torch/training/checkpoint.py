"""Checkpoints with torch.save / torch.load (counterpart of
keras_rs_tpu/training/checkpoint.py, which uses Orbax).

A state is an object with `state_dict()` / `load_state_dict()` (an
nn.Module, DenseAdam, DenseAdagrad, a PipelinedTrainState) or a mapping
of names to such objects, e.g. {"model": model, "optimizer": optimizer}.
A model's `state_dict()` holds its parameters and buffers, so every
embedding stack's table, optimizer slots and step counter travel with
it.

  * Writing goes to a temporary file in the target's directory that
    `os.replace` then moves into place, so a run killed mid-write never
    leaves a half-written checkpoint under the final name.
  * Restoring loads with `weights_only=True` to the CPU (memory-mapped,
    so a large state is read page by page), then copies into the
    template's existing tensors: the device never holds a second copy
    of the state.

Sharded state. Where the state holds a DistributedEmbedding sharded over
D > 1 ranks, every rank calls the same function at the same point, and a
checkpoint is a directory:

  * `rank{r}-of-{D}.pt`, written by each rank r: its shards (every
    stack buffer of the sharded layers: tables, slots, step counters,
    layout codes), D, the mesh's axis names and sizes, and the stack
    layouts (table names, local offsets, rotations, rows per shard);
  * `dense.pt`, written by rank 0 alone: the rest of the state, which
    every rank holds the same (dense replicas, the dense optimizer);
  * `COMPLETE`, written by rank 0 once every rank has reported its
    files written (an all_reduce of the ranks' failures, which is also
    the barrier): a directory without it, or without one of the files
    it names, is not a checkpoint.

Restoring needs a template of the same D, mesh and stack layouts
(rotation included): anything else raises with the difference. The JAX
package's global arrays have a row layout that depends on D too; the
port says so instead of loading rows into the wrong slots.

`save_checkpoint` blocks until the checkpoint is in place.
`CheckpointManager` keeps numbered checkpoints of a training loop: `save`
copies the state to host memory (a device sync; the training step
mutates the tables in place, so the copy must finish before it goes on)
and writes the files on a background thread. At D > 1 the thread only
writes files: the commit (the all_reduce, the marker and the pruning of
old steps) runs on the calling thread at the next `save`,
`wait_until_finished`, `latest_step`, `restore` or `close`, which every
rank calls at the same point of its program, so no collective runs
beside the training step's.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Mapping

import torch
import torch.distributed as dist

MARKER = "COMPLETE"
DENSE_FILE = "dense.pt"


def _rank_file(rank: int, world: int) -> str:
    return f"rank{rank}-of-{world}.pt"


def _modules_of(state: Any) -> list[torch.nn.Module]:
    """The modules a state holds: itself, a mapping's values, or an
    object's attributes (a PipelinedTrainState's model)."""
    if isinstance(state, torch.nn.Module):
        return [state]
    values = (state.values() if isinstance(state, Mapping)
              else vars(state).values() if hasattr(state, "__dict__")
              else ())
    return [v for v in values if isinstance(v, torch.nn.Module)]


def _sharded_layers(state: Any) -> list[tuple[str, torch.nn.Module]]:
    """(module path, layer) of every embedding layer sharded over more
    than one rank that the state holds."""
    out = []
    for i, m in enumerate(_modules_of(state)):
        for name, sub in m.named_modules():
            if getattr(sub, "num_shards", 1) > 1 and hasattr(sub, "stacks"):
                out.append((f"{i}:{name}", sub))
    return out


def _layouts(layers) -> dict[str, Any]:
    """What a sharded checkpoint must match: D, the mesh, and each
    layer's stacks (table name, local offset, rotation; rows per
    shard)."""
    if not layers:
        return {}
    mesh = layers[0][1].mesh
    return {
        "world": dist.get_world_size(),
        "mesh": {"axis_names": list(mesh.axis_names),
                 "axis_sizes": [mesh.shape[a] for a in mesh.axis_names]},
        "stacks": {
            path: [{"name": s.name, "rows_per_shard": s.rows_per_shard,
                    "tables": [[t.name, t.local_offset, t.rotation]
                               for t in s.tables]}
                   for s in layer.stacks]
            for path, layer in layers
        },
    }


def _shard_keys(layers) -> set[tuple]:
    """Storage, shape and type of every stack buffer of the sharded
    layers: a state dict's tensor is a shard when it matches one."""
    return {
        (b.data_ptr(), tuple(b.shape), b.dtype)
        for _, layer in layers
        for name, b in layer.named_buffers(recurse=False)
        if name.startswith("stack")
    }


def _split(tree: Any, keys: set[tuple], path: tuple = ()):
    """(the tree with its shard tensors replaced by None, {path: shard
    tensor})."""
    shards: dict[tuple, torch.Tensor] = {}

    def walk(x: Any, p: tuple) -> Any:
        if isinstance(x, torch.Tensor):
            if (x.data_ptr(), tuple(x.shape), x.dtype) in keys:
                shards[p] = x
                return None
            return x
        if isinstance(x, Mapping):
            return type(x)((k, walk(v, p + (k,))) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, p + (i,)) for i, v in enumerate(x))
        return x

    return walk(tree, path), shards


def _merge(tree: Any, shards: Mapping[tuple, Any]) -> Any:
    """The inverse of `_split`."""
    def walk(x: Any, p: tuple) -> Any:
        if p in shards:
            return shards[p]
        if isinstance(x, Mapping):
            return type(x)((k, walk(v, p + (k,))) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, p + (i,)) for i, v in enumerate(x))
        return x

    return walk(tree, ())


def _state_dict_of(state: Any) -> dict[str, Any]:
    """`state.state_dict()`, or {name: obj.state_dict()} of a mapping."""
    if hasattr(state, "state_dict"):
        return state.state_dict()
    if isinstance(state, Mapping):
        return {k: v.state_dict() for k, v in state.items()}
    raise TypeError(
        f"A checkpoint state has state_dict() or is a mapping of such "
        f"objects; got {type(state).__name__}."
    )


def _load_into(template: Any, saved: Mapping[str, Any]) -> None:
    """The inverse of `_state_dict_of`: copies `saved` into `template`."""
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return
    if set(template) != set(saved):
        raise ValueError(
            f"Checkpoint holds {sorted(saved)}, the template "
            f"{sorted(template)}."
        )
    for k, v in template.items():
        v.load_state_dict(saved[k])


def _atomic_save(obj: Any, path: str) -> None:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(
        directory, f".{os.path.basename(path)}.tmp-{os.getpid()}-"
        f"{threading.get_ident()}")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _snapshot(state: Any, layers, to_host: bool) -> tuple[dict, Any]:
    """(this rank's file, the dense file or None off rank 0) of a sharded
    state; with `to_host`, tensors are copied to host memory."""
    tree, shards = _split(_state_dict_of(state), _shard_keys(layers))
    if to_host:
        tree, shards = _to_host(tree), _to_host(shards)
    rank = dist.get_rank()
    mine = {"meta": _layouts(layers), "rank": rank,
            "shards": [[list(k), v] for k, v in shards.items()]}
    return mine, (tree if rank == 0 else None)


def _write_files(path: str, mine: dict, dense: Any) -> None:
    world = mine["meta"]["world"]
    _atomic_save(mine, os.path.join(path, _rank_file(mine["rank"], world)))
    if dense is not None:
        _atomic_save(dense, os.path.join(path, DENSE_FILE))


def _drop_marker(path: str) -> None:
    """Rank 0 takes the marker of `path` away before its files change."""
    marker = os.path.join(path, MARKER)
    if dist.get_rank() == 0 and os.path.exists(marker):
        os.remove(marker)


def _all_ok(ok: bool) -> bool:
    """Whether every rank is ok (an all_reduce: also a barrier)."""
    from keras_rs_tpu_torch.parallel import multihost

    failed = torch.tensor([0 if ok else 1], dtype=torch.int64,
                          device=multihost._collective_device())
    dist.all_reduce(failed)
    return int(failed) == 0


def _commit(path: str, meta: dict, ok: bool) -> None:
    """Rank 0 writes the marker once every rank has written its files;
    every rank returns after it is in place. Raises on every rank when
    one of them failed (no marker then)."""
    if not _all_ok(ok):
        raise RuntimeError(
            f"A rank failed to write its part of {path}: not committed.")
    if dist.get_rank() == 0:
        tmp = os.path.join(path, f".{MARKER}.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, MARKER))
    _all_ok(True)


def is_complete(path: str) -> bool:
    """Whether `path` is a whole sharded checkpoint: its marker, every
    rank's file and the dense file are there."""
    try:
        with open(os.path.join(path, MARKER)) as f:
            world = json.load(f)["world"]
    except (OSError, ValueError, KeyError):
        return False
    names = set(os.listdir(path))
    return DENSE_FILE in names and all(
        _rank_file(r, world) in names for r in range(world))


def _check_layout(path: str, saved: dict, want: dict) -> None:
    for key, what in (("world", "ranks (D)"), ("mesh", "mesh"),
                      ("stacks", "stack layouts (table order, offsets, "
                       "rotations)")):
        if saved.get(key) != want[key]:
            raise ValueError(
                f"The checkpoint {path} was saved with other {what}: "
                f"{saved.get(key)}; this state has {want[key]}. A sharded "
                "checkpoint restores into a state of the same D, mesh and "
                "layout only."
            )


def _restore_sharded(path: str, template: Any, layers) -> Any:
    if not is_complete(path):
        raise FileNotFoundError(
            f"{path} is not a complete sharded checkpoint (its marker or a "
            "rank's file is missing).")
    want = _layouts(layers)
    with open(os.path.join(path, MARKER)) as f:
        _check_layout(path, json.load(f), want)
    mine = torch.load(
        os.path.join(path, _rank_file(dist.get_rank(), want["world"])),
        map_location="cpu", weights_only=True, mmap=True)
    _check_layout(path, mine["meta"], want)
    tree = torch.load(os.path.join(path, DENSE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    _load_into(template, _merge(tree, {tuple(k): v
                                       for k, v in mine["shards"]}))
    return template


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Blocking save of `state` to the file `path` (replaced atomically;
    with force=False an existing file raises). A state sharded over D > 1
    ranks goes to the directory `path` (see the module docstring); every
    rank calls this."""
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    layers = _sharded_layers(state)
    if not layers:
        _atomic_save(_state_dict_of(state), path)
        return
    _drop_marker(path)
    mine, dense = _snapshot(state, layers, to_host=False)
    ok = False
    try:
        _write_files(path, mine, dense)
        ok = True
    finally:
        _commit(path, mine["meta"], ok)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Copies the checkpoint at `path` into `template`'s tensors in
    place; returns `template`. A sharded template restores from a
    sharded checkpoint of the same D, mesh and layout (every rank calls
    this); any other pairing raises."""
    layers = _sharded_layers(template)
    sharded = os.path.isdir(path)
    if sharded or layers:
        if not (sharded and layers):
            raise ValueError(
                f"{path} is {'a sharded' if sharded else 'a one-device'} "
                f"checkpoint; the template is "
                f"{'sharded' if layers else 'not sharded'} over ranks.")
        return _restore_sharded(path, template, layers)
    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    _load_into(template, saved)
    return template


def _to_host(tree: Any) -> Any:
    """A copy of a state dict with every tensor in host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Numbered checkpoints `<directory>/step_<N>.pt` (a sharded state:
    directories `<directory>/step_<N>/`, counted once complete); the
    newest `max_to_keep` are kept. At D > 1 every rank makes the same
    calls in the same order."""

    _NAME = re.compile(r"^step_(\d+)(\.pt)?$")

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}.")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        #: (directory, meta) of a sharded save whose files are being
        #: written: committed by wait_until_finished.
        self._pending: tuple[str, dict] | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, sharded: bool = False) -> str:
        name = f"step_{step}" if sharded else f"step_{step}.pt"
        return os.path.join(self.directory, name)

    def all_steps(self) -> list[int]:
        """The steps saved whole (a sharded step once complete)."""
        steps = set()
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m and (m.group(2) or is_complete(
                    os.path.join(self.directory, name))):
                steps.add(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _prune(self) -> None:
        """Deletes the checkpoints older than the newest max_to_keep
        (and the sharded directories of older steps that never
        completed)."""
        kept = self.all_steps()[-self.max_to_keep:]
        if not kept:
            return
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if not m or int(m.group(1)) >= kept[0]:
                continue
            path = os.path.join(self.directory, name)
            if m.group(2):
                os.remove(path)
            else:
                shutil.rmtree(path, ignore_errors=True)

    def save(self, step: int, state: Any) -> None:
        """Copies `state` to host memory now; writes it (and, for a
        one-device state, prunes the oldest checkpoints) on a background
        thread. A sharded step is committed and pruned by the next
        `wait_until_finished` (or `save`, `latest_step`, `restore`,
        `close`)."""
        self.wait_until_finished()
        layers = _sharded_layers(state)
        if layers:
            path = self._path(step, sharded=True)
            _drop_marker(path)
            mine, dense = _snapshot(state, layers, to_host=True)
            self._pending = (path, mine["meta"])

            def write() -> None:
                _write_files(path, mine, dense)
        else:
            snapshot = _to_host(_state_dict_of(state))

            def write() -> None:
                _atomic_save(snapshot, self._path(step))
                self._prune()

        def run() -> None:
            try:
                write()
            except Exception as e:  # re-raised by wait_until_finished
                self._error = e

        self._writer = threading.Thread(target=run, daemon=False)
        self._writer.start()

    def restore(self, step: int | None, template: Any) -> Any:
        """Copies checkpoint `step` (None: the latest) into `template`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoint found in {self.directory}.")
        self.wait_until_finished()
        sharded = os.path.isdir(self._path(step, sharded=True))
        return restore_checkpoint(self._path(step, sharded), template)

    def wait_until_finished(self) -> None:
        """Joins the pending write and commits a sharded one (every rank
        at once); raises the error it met, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        error, self._error = self._error, None
        if self._pending is not None:
            (path, meta), self._pending = self._pending, None
            try:
                _commit(path, meta, error is None)
            except RuntimeError:
                if error is None:
                    raise
            if error is None:
                if dist.get_rank() == 0:
                    self._prune()
                _all_ok(True)  # every rank sees the pruned directory
        if error is not None:
            raise error

    def close(self) -> None:
        self.wait_until_finished()
