"""The system under test over D ranks: the port's ml_perf training step
as `keras_rs_tpu_torch/examples/ml_perf/main.py` runs it under torchrun,
one rank per device, and the readings of the whole model that the output
check compares. The interface is port.py's (`build`, `load_weights`,
`Trainer`, `first_readings`, `late_readings`); a configuration names this
module as its `port_module`.

D is the default process group's size (1 without a group, where every
function below does what port.py does). The harness starts the group
before `build` (run.py); this rank's device and shard come from it.

`build` makes the model as `main.build_model` does at D ranks:
`model_config` at D (the worst-case capacities of B / D samples a rank),
on the mesh over the group, with a generator seeded alike on every rank.
`load_weights` writes the benchmark's own weights (weights.py) into this
rank's shard, placing logical row r of a table as the port's layout
documents it (layers/embedding/stacking.py): on shard (r + rotation) % D
at local row `local_offset + r // D`, so that D = 1 and D = N start from
the same model. `Trainer` hands each rank its B / D rows of every pool
batch (rows [rank B / D, (rank + 1) B / D), as main.py's process slicing
does), while `global_batch_size` stays the global batch.

Readings are of the whole model: a dense leaf is a replica, equal on
every rank (the step sums the dense gradients over the ranks); a large
table's squared change is summed over the ranks' shards in one
all-reduce. The snapshot after the window is gathered on rank 0, the
only rank that runs the reference; the others return None for it.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from benchmark import reference as ref
from benchmark import weights as W
from benchmark.port import _rows, _steps, experiment_config
from benchmark.spec import derive
from benchmark.traffic import large_features
from keras_rs_tpu_torch.data.loader import ThreadedDataLoader
from keras_rs_tpu_torch.examples.ml_perf import main as ml_main
from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)


def world() -> tuple[int, int]:
    """(this rank, D) of the default process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def build(config: dict, traffic: dict, seed: int, device) -> DLRMDCNv2:
    """This rank's part of the port's model, as `main.build_model` builds
    it at D ranks."""
    device = torch.device(device)
    mesh = mesh_lib.create_mesh(device)
    dlrm_cfg = ml_main.model_config(experiment_config(config, traffic),
                                    mesh.size)
    dlrm_cfg.table_dtype = config["table_dtype"]
    dlrm_cfg.embedding_optimizer = config["embedding_optimizer"]
    dlrm_cfg.compute_dtype = config["compute_dtype"]
    return DLRMDCNv2(
        dlrm_cfg,
        generator=torch.Generator(device=device).manual_seed(
            derive(seed, "port")),
        device=device,
        mesh=mesh,
    )


def _table(model: DLRMDCNv2, name: str) -> tuple[Any, Any, dict]:
    layer = model.embedding_layer
    for i, stack in enumerate(layer.stacks):
        for t in stack.tables:
            if t.name == name:
                if stack.num_shards != world()[1]:
                    raise ValueError(f"stack {stack.name} has "
                                     f"{stack.num_shards} shards for "
                                     f"{world()[1]} ranks")
                return stack, t, layer.stack_state(i)
    raise KeyError(name)


def _mine(t, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the ids of sorted `ids` that live on this rank's shard, their
    local rows)."""
    rank, D = world()
    here = ids[(ids + t.rotation) % D == rank]
    return here, here // D + t.local_offset


@torch.no_grad()
def load_weights(model: DLRMDCNv2, config: dict, seed: int) -> None:
    """Writes the benchmark's weights (weights.py) over the port's draw:
    every dense parameter, and this rank's rows of every large table,
    block by block, straight into its shard of the stacked state."""
    shapes = ref.dense_leaf_shapes(config)
    params = dict(model.named_parameters())
    if list(params) != list(shapes):
        raise ValueError(f"the port's parameters {list(params)} are not the "
                         f"reference's {list(shapes)}")
    for name, p in params.items():
        p.copy_(W.dense_leaf(seed, name, tuple(p.shape), p.device))
    rank, D = world()
    for i in large_features(config):
        name = ref.table_name(i)
        stack, t, state = _table(model, name)
        table = state["table"]
        vocab = config["vocab_sizes"][i]
        for block in range(-(-vocab // W.BLOCK_ROWS)):
            values = W.table_block(config, seed, name, vocab, block,
                                   table.device)
            lo = block * W.BLOCK_ROWS
            # The block's rows on this shard: every D-th from `first`,
            # at consecutive local rows.
            first = (rank - t.rotation - lo) % D
            mine = values[first::D].to(table.dtype)
            at = t.local_offset + (lo + first) // D
            rows = slice(at, at + mine.shape[0])
            if table.ndim == 3:
                table[rows, 0, : t.embedding_dim] = mine
            else:
                table[rows, : t.embedding_dim] = mine
            del values, mine


def _all_ranks_sum(values: list[float], device) -> list[float]:
    """`values` summed over the ranks (float64, one all-reduce)."""
    if not dist.is_initialized() or not values:
        return values
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.tolist()


@torch.no_grad()
def change_norms(model: DLRMDCNv2, ids: dict[int, torch.Tensor],
                 dense0: dict[str, torch.Tensor],
                 rows0: Callable[[int, int, int, int], torch.Tensor]
                 ) -> dict[str, float]:
    """Each leaf's change from a start, over the whole model: the dense
    parameters (replicas) whole against `dense0`; large table i over the
    sorted ids of `ids[i]` that live on this shard, block of ids by block
    (weights.blocks_of) against `rows0(i, block, lo, hi)`, the start rows
    of this shard's ids [lo, hi), squared and summed over the ranks."""
    out = {name: float((p.double() - dense0[name].double()).norm())
           for name, p in model.named_parameters()}
    names, squares = [], []
    for i, u in ids.items():
        stack, t, state = _table(model, ref.table_name(i))
        u, slots = _mine(t, u)
        total = torch.zeros((), dtype=torch.float64, device=u.device)
        for block, lo, hi in W.blocks_of(u):
            now = _rows(state["table"], slots[lo:hi], t.embedding_dim)
            total += (now.double() - rows0(i, block, lo, hi).double()
                      ).square().sum()
            del now
        names.append(ref.table_name(i))
        squares.append(float(total))
    summed = _all_ranks_sum(squares, model.device)
    out.update({n: s ** 0.5 for n, s in zip(names, summed)})
    return out


def _initial_change_norms(model: DLRMDCNv2, config: dict, seed: int,
                          batches: list[dict]) -> dict[str, float]:
    """`change_norms` from the seed's weights, over the rows `batches`
    touch."""
    device = model.device
    ids = ref.batch_ids(config, batches, device)
    here = {i: _mine(_table(model, ref.table_name(i))[1], u)[0]
            for i, u in ids.items()}

    def rows0(i, block, lo, hi):
        values = W.table_block(config, seed, ref.table_name(i),
                               config["vocab_sizes"][i], block, device)
        return values[here[i][lo:hi] - block * W.BLOCK_ROWS]

    dense0 = {n: W.dense_leaf(seed, n, tuple(p.shape), device)
              for n, p in model.named_parameters()}
    return change_norms(model, ids, dense0, rows0)


def first_readings(trainer: "Trainer", config: dict, seed: int,
                   pool: list[dict], sync: Callable[[], None]
                   ) -> tuple[ref.Readings, float]:
    """port.first_readings over the whole model: the first CHECK_STEPS
    steps through the trainer's own loader and step, the losses (the
    global batch's, as the step returns them), the first gradient worked
    out from the change after step 1 and the change after the last."""
    losses = _steps(trainer, 1)
    sync()
    t = time.perf_counter()
    scale = ref.grad_scale(config)
    grads = {name: c * scale for name, c in _initial_change_norms(
        trainer.model, config, seed, pool[:1]).items()}
    read_s = time.perf_counter() - t
    losses += _steps(trainer, ref.CHECK_STEPS - 1)
    sync()
    t = time.perf_counter()
    readings = ref.Readings(
        losses=losses, grad_norms=grads,
        change_norms=_initial_change_norms(trainer.model, config, seed,
                                           pool[: ref.CHECK_STEPS]))
    return readings, read_s + time.perf_counter() - t


@torch.no_grad()
def _gather_rows(t, ids: torch.Tensor, mine: torch.Tensor
                 ) -> torch.Tensor | None:
    """On rank 0, the rows of every id of sorted `ids`, assembled from
    each rank's `mine` (its own ids' rows, in order); None elsewhere."""
    rank, D = world()
    if D == 1:
        return mine
    owner = (ids + t.rotation) % D
    most = int(torch.bincount(owner, minlength=D).max())
    pad = mine.new_zeros((most,) + tuple(mine.shape[1:]))
    pad[: mine.shape[0]] = mine
    parts = [torch.empty_like(pad) for _ in range(D)] if rank == 0 else None
    dist.gather(pad, parts, dst=0)
    if rank != 0:
        return None
    out = mine.new_empty((ids.numel(),) + tuple(mine.shape[1:]))
    for r, part in enumerate(parts):
        at = owner == r
        out[at] = part[: int(at.sum())]
    return out


@torch.no_grad()
def snapshot(trainer: "Trainer", config: dict, batches: list[dict]
             ) -> tuple[ref.Start | None, dict[str, torch.Tensor],
                        dict[int, torch.Tensor]]:
    """(the port's state as `batches` will start from it, on rank 0 and
    None elsewhere; this rank's copy of the dense leaves; this shard's
    copy of the rows they touch, by table). The Start holds the dense leaves and their Adagrad accumulators (this
    rank's replica) and every row the batches touch with its
    accumulator, gathered from the shards."""
    model = trainer.model
    params = dict(model.named_parameters())
    dense = {n: p.detach().float().clone() for n, p in params.items()}
    dense_acc = {n: a.float().clone() for n, a in zip(
        params, trainer.optimizer.accumulators)}
    ids = ref.batch_ids(config, batches, model.device)
    rows, acc, local = {}, {}, {}
    for i, u in ids.items():
        stack, t, state = _table(model, ref.table_name(i))
        slots = _mine(t, u)[1]
        local[i] = _rows(state["table"], slots, t.embedding_dim)
        if state["table"].ndim == 3:
            a = state["table"][slots, 1, : t.embedding_dim].float()
        else:
            a = state["slots"]["accumulator"][slots]
            a = (a[:, : t.embedding_dim] if a.ndim == 2 else a).float()
        rows[i] = _gather_rows(t, u, local[i])
        acc[i] = _gather_rows(t, u, a)
        del a
    if world()[0] != 0:
        return None, dense, local
    return ref.Start(dense=dense, dense_acc=dense_acc, ids=ids, rows=rows,
                     acc=acc), dense, local


def late_readings(trainer: "Trainer", config: dict, batches: list[dict],
                  sync: Callable[[], None]) -> tuple[ref.Readings,
                                                     ref.Start | None]:
    """port.late_readings over the whole model: snapshots the port's
    state, runs the next CHECK_STEPS steps through the trainer's own
    loader and step (`batches` are the global batches whose rows the
    loader hands over next), and reads each leaf's change from the
    snapshot. Returns (the readings, the snapshot on rank 0, else None)."""
    sync()
    start, dense0, local = snapshot(trainer, config,
                                    batches[: ref.CHECK_STEPS])
    ids = ref.batch_ids(config, batches[: ref.CHECK_STEPS],
                        trainer.model.device)
    losses = []
    for k in range(ref.CHECK_STEPS):
        batch = next(trainer.loader)
        if not torch.equal(batch["label"].cpu(), torch.as_tensor(
                trainer.rows(batches[k])["label"])):
            raise RuntimeError("the loader's next batch is not the one "
                               "the pool holds next")
        losses.append(float(trainer.step(batch)))
    sync()
    readings = ref.Readings(
        losses=losses, grad_norms={},
        change_norms=change_norms(
            trainer.model, ids, dense0,
            lambda i, block, lo, hi: local[i][lo:hi]))
    return readings, start


class Trainer:
    """The training step and loader as main.py assembles them in device
    mode at D ranks, over the run's pool of raw global batches (cycled),
    each rank taking its B / D rows of every batch."""

    def __init__(self, model: DLRMDCNv2, config: dict, pool: list[dict],
                 loss_fn: Callable | None = None) -> None:
        self.model = model
        rank, D = world()
        B = int(config["global_batch_size"])
        if B % D:
            raise ValueError(f"a global batch of {B} over {D} ranks")
        self._rows = slice(rank * (B // D), (rank + 1) * (B // D))
        self.optimizer = DenseAdagrad(model.parameters(),
                                      config["learning_rate"])
        self.step = make_train_step(
            model, loss_fn or ml_main.make_loss_fn(True), self.optimizer,
            mesh=model.embedding_layer.mesh)
        self.loader = ThreadedDataLoader(
            itertools.cycle(pool), lambda b: ml_main._raw(self.rows(b)),
            transfer_fn=model.to_device, num_workers=1)

    def rows(self, batch: dict) -> dict[str, np.ndarray]:
        """This rank's rows of a global batch."""
        return {k: np.asarray(v)[self._rows] for k, v in batch.items()}

    def stop(self) -> None:
        self.loader.stop()
