"""Host-side training loop (counterpart of keras_rs_tpu/training/trainer.py).

An explicit loop around `make_train_step`. A batch is a dict, tuple or
list (nested freely) of numpy arrays or tensors; it moves to the device
of the model's parameters before the step. `fit` adds what a production
loop needs:

  * `prefetch`: batches copied ahead on a side stream (`prefetch_to_device`),
    with `prefetch_sharding` as this rank's rows of each global batch;
  * `profile_dir`: a torch.profiler Chrome trace of `profile_steps`;
  * `validation_fn`, `checkpoint_dir` (`last` every epoch, `best` at the
    lowest validation value) and a JSONL `metrics_log`.

With a `mesh` of D > 1 ranks the trainer is data parallel
(`make_train_step(mesh=)`): each rank steps on its rows of the batch
(`parallel.mesh.put_batch`, or `fit(prefetch_sharding=mesh)` on global
batches) and the dense gradients are summed over the ranks.

The step's loss stays on the device: the host reads it once per epoch
(its mean) and every `log_every` steps, as the JAX loop does.
`evaluate` accumulates metric states and the loss on the device and
reads them once at the end.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Any, Callable, Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.training.checkpoint import save_checkpoint
from keras_rs_tpu_torch.training.train_state import make_train_step
from keras_rs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("keras_rs_tpu_torch")


def _map(batch: Any, fn: Callable[[Any], Any]) -> Any:
    """`fn` over every leaf of a dict / tuple / list structure."""
    if isinstance(batch, Mapping):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(v, fn) for v in batch)
    return fn(batch)


def _as_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def batch_to_device(batch: Any, device: torch.device) -> Any:
    """Every leaf of `batch` as a tensor on `device`."""
    return _map(batch, lambda a: _as_tensor(a).to(device))


def rank_rows(batch: Any, sharding: Any) -> Any:
    """This rank's rows (dim 0) of every leaf of a global batch, as the
    JAX package's batch sharding places them: `sharding` is a Mesh (rows
    over all its axes, as make_train_step(mesh=) splits a batch) or a
    (mesh, axis_name) pair."""
    mesh, axes = (sharding if isinstance(sharding, tuple)
                  else (sharding, sharding.axis_names))

    def rows(a: Any) -> Any:
        return a[mesh_lib.batch_rows(mesh, a.shape[0], axes)]

    return _map(batch, rows)


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       device: Any = None,
                       sharding: Any = None) -> Iterator[Any]:
    """Yields the batches of `iterator` on `device`, `size` ahead.

    On a CUDA device each batch is pinned and copied with non_blocking
    copies on a side stream; the consuming stream waits on the batch's
    event before it is yielded, so the copies overlap the steps before
    it. On a CPU device the batches pass through as they are. With
    `sharding` (see `rank_rows`) only this rank's rows of each global
    batch are kept, before the copy, so the prefetch does not undo the
    data-parallel split.
    """
    device = resolve_device(device)
    if sharding is not None:
        iterator = (rank_rows(b, sharding) for b in iterator)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        host = _map(batch, lambda a: _as_tensor(a).pin_memory())
        with torch.cuda.stream(copy_stream):
            moved = _map(host, lambda t: t.to(device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return moved, ready

    buf: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        moved, ready = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        # The memory was allocated on the copy stream: tell the caching
        # allocator that the consumer uses it too.
        _map(moved, lambda t: t.record_stream(consumer))
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield moved


class Trainer:
    """Minimal, explicit trainer.

    Args:
        model: an nn.Module.
        optimizer: an object with `step()`, `zero_grad()`,
            `state_dict()` and `load_state_dict()` over the model's
            parameters (`DenseAdam`, `DenseAdagrad`).
        loss_fn: callable (model, batch) -> scalar loss, or (loss, aux).
        has_aux: whether loss_fn returns (loss, aux); `step` then returns
            (loss, aux), and `fit` and `evaluate` read the loss from it.
        mesh: a parallel.mesh.Mesh of D > 1 ranks makes the step data
            parallel (make_train_step(mesh=)): each batch is this rank's
            rows, and the step returns the global batch's loss.
    """

    def __init__(self, model: nn.Module, optimizer: Any,
                 loss_fn: Callable[[nn.Module, Any], Any], *,
                 has_aux: bool = False, mesh: Any = None) -> None:
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.has_aux = has_aux
        self.device = next(model.parameters()).device
        self._step_fn = make_train_step(model, loss_fn, optimizer,
                                        has_aux=has_aux, mesh=mesh)

    @property
    def state(self) -> dict[str, Any]:
        """What a checkpoint holds: {"model", "optimizer"}
        (training/checkpoint.py saves and restores it)."""
        return {"model": self.model, "optimizer": self.optimizer}

    def step(self, batch: Any) -> Any:
        """One training step; returns the detached loss, or (loss, aux)
        with `has_aux` (no host sync)."""
        return self._step_fn(batch_to_device(batch, self.device))

    def fit(
        self,
        data: Iterable[Any] | Callable[[], Iterable[Any]],
        *,
        epochs: int = 1,
        steps_per_epoch: int | None = None,
        log_every: int = 100,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (10, 20),
        prefetch: int = 0,
        prefetch_sharding: Any = None,
        validation_fn: Callable[[nn.Module], float] | None = None,
        checkpoint_dir: str | None = None,
        metrics_log: str | None = None,
    ) -> dict[str, list[float]]:
        """Runs the loop; returns {"loss": [mean step loss per epoch]}
        (and "val": [validation_fn(model) per epoch]). For more than one
        epoch pass a callable that returns a fresh iterator per epoch.

        prefetch: > 0 keeps that many batches copied ahead.
        prefetch_sharding: with `prefetch`, `data` yields global batches
            and each is cut to this rank's rows before its copy
            (`rank_rows`: a Mesh, or a (mesh, axis_name) pair).
        profile_dir: traces global steps profile_steps[0] to
            profile_steps[1] (inclusive) with torch.profiler and writes a
            Chrome trace there.
        checkpoint_dir: `<dir>/last` after every epoch and, with
            `validation_fn`, `<dir>/best` at the lowest value (restore
            with checkpoint.restore_checkpoint(path, trainer.state)).
        metrics_log: a JSONL file appended with one record per epoch.
        """
        history: dict[str, list[float]] = {"loss": []}
        if validation_fn is not None:
            history["val"] = []
        best_val = float("inf")
        global_step = 0
        profiler = None
        try:
            for epoch in range(epochs):
                epoch_data = data() if callable(data) else data
                if prefetch:
                    epoch_data = prefetch_to_device(
                        epoch_data, prefetch, self.device,
                        sharding=prefetch_sharding)
                losses = []
                t0 = time.time()
                for i, batch in enumerate(epoch_data):
                    if steps_per_epoch is not None and i >= steps_per_epoch:
                        break
                    if profile_dir and global_step == profile_steps[0]:
                        profiler = start_profiler(self.device)
                    out = self.step(batch)
                    losses.append(out[0] if self.has_aux else out)
                    if profiler is not None and (
                            global_step == profile_steps[1]):
                        stop_profiler(profiler, profile_dir, self.device)
                        profiler = None
                    global_step += 1
                    if log_every and (i + 1) % log_every == 0:
                        logger.info("epoch %d step %d loss %.5f", epoch,
                                    i + 1, float(losses[-1]))
                if not losses:
                    raise ValueError(
                        "Dataset yielded no batches. For multi-epoch "
                        "training pass a callable returning a fresh "
                        "iterator per epoch."
                    )
                epoch_loss = float(torch.stack(losses).double().mean())
                history["loss"].append(epoch_loss)
                record: dict[str, Any] = {
                    "epoch": epoch,
                    "loss": epoch_loss,
                    "seconds": round(time.time() - t0, 2),
                }
                if checkpoint_dir is not None:
                    save_checkpoint(os.path.join(checkpoint_dir, "last"),
                                    self.state)
                if validation_fn is not None:
                    val = float(validation_fn(self.model))
                    history["val"].append(val)
                    record["val"] = val
                    if checkpoint_dir is not None and val < best_val:
                        best_val = val
                        save_checkpoint(os.path.join(checkpoint_dir, "best"),
                                        self.state)
                if metrics_log:
                    with open(metrics_log, "a") as f:
                        f.write(json.dumps(record) + "\n")
                logger.info("epoch %d done in %.1fs loss %.5f", epoch,
                            time.time() - t0, epoch_loss)
        finally:
            if profiler is not None:  # the run ended inside the window
                stop_profiler(profiler, profile_dir, self.device)
        return history

    @torch.no_grad()
    def evaluate(
        self,
        data: Iterable[Any],
        metric_fns: Mapping[str, Any] | None = None,
        eval_fn: Callable[..., tuple] | None = None,
        *,
        report_loss: bool = True,
    ) -> dict[str, float]:
        """Metrics (and the training loss) over a dataset.

        `eval_fn(model, batch)` turns a batch into metric inputs,
        `(y_true, y_pred)` or `(y_true, y_pred, sample_weight)`; by
        default the batch is (x, y) and model(x) the prediction. Each
        metric's state (`init_state` / `update` / `result_from_state`)
        stays on the device until the end. With `report_loss`, "loss" is
        the mean of `loss_fn` weighted by each batch's row count.
        """
        metric_fns = metric_fns or {}
        if eval_fn is None:
            def eval_fn(model, batch):
                return batch[1], model(batch[0])

        states = {name: m.init_state() for name, m in metric_fns.items()}
        loss_total = torch.zeros((), dtype=torch.float32, device=self.device)
        count = 0
        n_batches = 0
        for batch in data:
            batch = batch_to_device(batch, self.device)
            out = eval_fn(self.model, batch)
            y_true, y_pred = out[0], out[1]
            sample_weight = out[2] if len(out) > 2 else None
            for name, m in metric_fns.items():
                states[name] = m.update(states[name], y_true, y_pred,
                                        sample_weight)
            if report_loss:
                n = _leading_dim(y_pred)
                loss = self.loss_fn(self.model, batch)
                if self.has_aux:
                    loss = loss[0]
                loss_total = loss_total + loss.float() * n
                count += n
            n_batches += 1
        if n_batches == 0:
            raise ValueError("evaluate() received an empty dataset.")
        results = {name: float(m.result_from_state(states[name]))
                   for name, m in metric_fns.items()}
        if report_loss:
            results["loss"] = float(loss_total) / max(float(count), 1.0)
        return results


def _leading_dim(tree: Any) -> int:
    """The row count of a prediction (its first leaf's leading dim)."""
    leaves: list = []
    _map(tree, leaves.append)
    return int(leaves[0].shape[0])


def start_profiler(device: torch.device):
    """A running torch.profiler session (CPU, and CUDA on a card)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def stop_profiler(prof, profile_dir: str, device: torch.device) -> None:
    """Ends `prof` after the device's work and writes its Chrome trace
    to a new file in `profile_dir`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace-{os.getpid()}-"
                        f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)
