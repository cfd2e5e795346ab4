"""Checkpoints with torch.save / torch.load (counterpart of
keras_rs_tpu/training/checkpoint.py, which uses Orbax).

A state is an object with `state_dict()` / `load_state_dict()` (an
nn.Module, DenseAdam, DenseAdagrad) or a mapping of names to such
objects, e.g. {"model": model, "optimizer": optimizer}. A model's
`state_dict()` holds its parameters and buffers, so every embedding
stack's table, optimizer slots and step counter travel with it.

  * Writing goes to a temporary file in the target's directory that
    `os.replace` then moves into place, so a run killed mid-write never
    leaves a half-written checkpoint under the final name.
  * Restoring loads with `weights_only=True` to the CPU (memory-mapped,
    so a large state is read page by page), then copies into the
    template's existing tensors: the device never holds a second copy
    of the state.

`save_checkpoint` blocks until the file is in place. `CheckpointManager`
keeps numbered checkpoints of a training loop: `save` copies the state
to host memory (a device sync; the training step mutates the tables in
place, so the copy must finish before it goes on) and writes the file on
a background thread.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Mapping

import torch


def _refuse_sharded(state: Any) -> None:
    """Raises for a state holding a DistributedEmbedding sharded over
    more than one rank: its checkpoints are not ported yet."""
    modules = ([state] if isinstance(state, torch.nn.Module)
               else list(state.values()) if isinstance(state, Mapping)
               else [])
    for m in modules:
        if not isinstance(m, torch.nn.Module):
            continue
        for sub in m.modules():
            if getattr(sub, "num_shards", 1) > 1:
                raise NotImplementedError(
                    "Checkpoints of embedding state sharded over more than "
                    "one rank are not ported to keras_rs_tpu_torch yet "
                    "(ROADMAP A10, second half)."
                )


def _state_dict_of(state: Any) -> dict[str, Any]:
    """`state.state_dict()`, or {name: obj.state_dict()} of a mapping."""
    _refuse_sharded(state)
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


def save_checkpoint(path: str, state: Any, *, force: bool = True) -> None:
    """Blocking save of `state` to the file `path` (replaced atomically;
    with force=False an existing file raises)."""
    if not force and os.path.exists(path):
        raise FileExistsError(path)
    _atomic_save(_state_dict_of(state), path)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Copies the checkpoint at `path` into `template`'s tensors in
    place; returns `template`."""
    _refuse_sharded(template)
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
    """Numbered checkpoints `<directory>/step_<N>.pt`; the newest
    `max_to_keep` are kept."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}.")
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for m in map(self._NAME.match,
                                         os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Copies `state` to host memory now; writes it (and prunes the
        oldest checkpoints) on a background thread."""
        self.wait_until_finished()
        snapshot = _to_host(_state_dict_of(state))

        def write() -> None:
            try:
                _atomic_save(snapshot, self._path(step))
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self._path(old))
            except Exception as e:  # re-raised by wait_until_finished
                self._error = e

        self._writer = threading.Thread(target=write, daemon=False)
        self._writer.start()

    def restore(self, step: int | None, template: Any) -> Any:
        """Copies checkpoint `step` (None: the latest) into `template`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoint found in {self.directory}.")
        self.wait_until_finished()
        return restore_checkpoint(self._path(step), template)

    def wait_until_finished(self) -> None:
        """Joins the pending write; raises the error it met, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait_until_finished()
