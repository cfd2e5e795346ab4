"""The system under test: the port's ml_perf training step, assembled with
the calls `keras_rs_tpu_torch/examples/ml_perf/main.py` makes in
device-COO mode, and the readings of its state that the output check
compares.

`build` makes the model as `main.build_model` does (`model_config` of the
ml_perf config at D = 1, the worst-case capacities of the traffic's
valences), with the configuration's table dtype and embedding optimizer
and a generator seeded from the run, then writes the benchmark's own
weights over the port's draw (weights.py). `Trainer` holds the step
(`make_train_step(model, make_loss_fn(True), DenseAdagrad(...))`) and the
loader (`ThreadedDataLoader` over the run's pool of raw batches, one
worker, so the batches come in the pool's order, and the pinned copy to
the device in the consuming thread).

`first_readings` reads the first checked steps against the seed's
weights; `late_readings` copies the port's state after the window
(`snapshot`) and reads the next three steps against it.

The state readers know the one-device layout of a stacked table
(layers/embedding/stacking.py): logical row r of a table lies at row
`local_offset + r` of its stack, the packed state's [row, 0] is the table
row and [row, 1] its Adagrad accumulator, a split stack keeps its
accumulator in `slots["accumulator"]`.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable

import numpy as np
import torch

from benchmark import reference as ref
from benchmark import weights as W
from benchmark.spec import derive
from benchmark.traffic import large_features
from keras_rs_tpu_torch.data.loader import ThreadedDataLoader
from keras_rs_tpu_torch.examples.ml_perf import configs as ml_configs
from keras_rs_tpu_torch.examples.ml_perf import main as ml_main
from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)


def experiment_config(config: dict, traffic: dict):
    """The ml_perf ExperimentConfig of this configuration and mix."""
    return ml_configs.full_criteo(
        name=config["name"],
        vocab_sizes=list(config["vocab_sizes"]),
        multi_hot_sizes=list(traffic["valences"]),
        embedding_dim=config["embedding_dim"],
        bottom_mlp=tuple(config["bottom_mlp"]),
        top_mlp=tuple(config["top_mlp"]),
        num_dcn_layers=config["num_dcn_layers"],
        dcn_projection_dim=config["dcn_projection_dim"],
        embedding_threshold=config["embedding_threshold"],
        learning_rate=config["learning_rate"],
        global_batch_size=config["global_batch_size"],
        dense_output_dtype=config["dense_output_dtype"],
        device_preprocessing=True,
    )


def build(config: dict, traffic: dict, seed: int, device) -> DLRMDCNv2:
    """The port's model for this cell, as `main.build_model` builds it."""
    device = torch.device(device)
    dlrm_cfg = ml_main.model_config(experiment_config(config, traffic), 1)
    dlrm_cfg.table_dtype = config["table_dtype"]
    dlrm_cfg.embedding_optimizer = config["embedding_optimizer"]
    dlrm_cfg.compute_dtype = config["compute_dtype"]
    return DLRMDCNv2(
        dlrm_cfg,
        generator=torch.Generator(device=device).manual_seed(
            derive(seed, "port")),
        device=device,
    )


def _table(model: DLRMDCNv2, name: str) -> tuple[Any, Any, dict]:
    layer = model.embedding_layer
    for i, stack in enumerate(layer.stacks):
        for t in stack.tables:
            if t.name == name:
                if stack.num_shards != 1:
                    raise ValueError("the benchmark runs one shard")
                return stack, t, layer.stack_state(i)
    raise KeyError(name)


@torch.no_grad()
def load_weights(model: DLRMDCNv2, config: dict, seed: int) -> None:
    """Writes the benchmark's weights (weights.py) over the port's draw:
    every dense parameter, and every large table block by block straight
    into the stacked state."""
    shapes = ref.dense_leaf_shapes(config)
    params = dict(model.named_parameters())
    if list(params) != list(shapes):
        raise ValueError(f"the port's parameters {list(params)} are not the "
                         f"reference's {list(shapes)}")
    for name, p in params.items():
        p.copy_(W.dense_leaf(seed, name, tuple(p.shape), p.device))
    for i in large_features(config):
        name = ref.table_name(i)
        stack, t, state = _table(model, name)
        table = state["table"]
        vocab = config["vocab_sizes"][i]
        for block in range(-(-vocab // W.BLOCK_ROWS)):
            values = W.table_block(config, seed, name, vocab, block,
                                   table.device)
            lo = t.local_offset + block * W.BLOCK_ROWS
            rows = slice(lo, lo + values.shape[0])
            if table.ndim == 3:
                table[rows, 0, : t.embedding_dim] = values.to(table.dtype)
            else:
                table[rows, : t.embedding_dim] = values.to(table.dtype)
            del values


def _rows(table: torch.Tensor, rows: torch.Tensor, dim: int
          ) -> torch.Tensor:
    """The stored rows `rows` of a stack's table, f32."""
    if table.ndim == 3:
        return table[rows, 0, :dim].float()
    return table[rows, :dim].float()


@torch.no_grad()
def snapshot(trainer: "Trainer", config: dict, batches: list[dict]
             ) -> ref.Start:
    """The port's state as `batches` will start from it (reference.Start):
    the dense leaves and their Adagrad accumulators, and the rows the
    batches touch with their accumulators, copied."""
    model = trainer.model
    params = dict(model.named_parameters())
    dense = {n: p.detach().float().clone() for n, p in params.items()}
    dense_acc = {n: a.float().clone() for n, a in zip(
        params, trainer.optimizer.accumulators)}
    ids = ref.batch_ids(config, batches, model.device)
    rows, acc = {}, {}
    for i, u in ids.items():
        stack, t, state = _table(model, ref.table_name(i))
        slots = u + t.local_offset
        rows[i] = _rows(state["table"], slots, t.embedding_dim)
        if state["table"].ndim == 3:
            acc[i] = state["table"][slots, 1, : t.embedding_dim].float()
        else:
            a = state["slots"]["accumulator"][slots]
            acc[i] = (a[:, : t.embedding_dim] if a.ndim == 2 else a).float()
    return ref.Start(dense=dense, dense_acc=dense_acc, ids=ids, rows=rows,
                     acc=acc)


@torch.no_grad()
def change_norms(model: DLRMDCNv2, ids: dict[int, torch.Tensor],
                 dense0: dict[str, torch.Tensor],
                 rows0: Callable[[int, int, int, int], torch.Tensor]
                 ) -> dict[str, float]:
    """Each leaf's change from a start: the dense parameters whole against
    `dense0`, large table i over its sorted `ids[i]`, block of ids by
    block (weights.blocks_of) against `rows0(i, block, lo, hi)`, the start
    rows of ids[i][lo:hi]."""
    out = {name: float((p.double() - dense0[name].double()).norm())
           for name, p in model.named_parameters()}
    for i, u in ids.items():
        stack, t, state = _table(model, ref.table_name(i))
        total = torch.zeros((), dtype=torch.float64, device=u.device)
        for block, lo, hi in W.blocks_of(u):
            now = _rows(state["table"], u[lo:hi] + t.local_offset,
                        t.embedding_dim)
            total += (now.double() - rows0(i, block, lo, hi).double()
                      ).square().sum()
            del now
        out[ref.table_name(i)] = float(total.sqrt())
    return out


def _initial_change_norms(model: DLRMDCNv2, config: dict, seed: int,
                          batches: list[dict]) -> dict[str, float]:
    """`change_norms` from the seed's weights, over the rows `batches`
    touch."""
    device = model.device
    ids = ref.batch_ids(config, batches, device)

    def rows0(i, block, lo, hi):
        values = W.table_block(config, seed, ref.table_name(i),
                               config["vocab_sizes"][i], block, device)
        return values[ids[i][lo:hi] - block * W.BLOCK_ROWS]

    dense0 = {n: W.dense_leaf(seed, n, tuple(p.shape), device)
              for n, p in model.named_parameters()}
    return change_norms(model, ids, dense0, rows0)


def _steps(trainer: "Trainer", n: int) -> list[float]:
    return [float(trainer.step(next(trainer.loader))) for _ in range(n)]


def first_readings(trainer: "Trainer", config: dict, seed: int,
                   pool: list[dict], sync: Callable[[], None]
                   ) -> tuple[ref.Readings, float]:
    """Runs the first CHECK_STEPS steps through the trainer's own loader
    and step, and reads the port's state as the output check compares it:
    the losses, the first gradient worked out from the change after step
    1 (reference.grad_scale) and the change after the last. Returns (the
    readings, the seconds the reading took)."""
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


def late_readings(trainer: "Trainer", config: dict, batches: list[dict],
                  sync: Callable[[], None]) -> tuple[ref.Readings,
                                                     ref.Start]:
    """Snapshots the port's state, runs the next CHECK_STEPS steps through
    the trainer's own loader and step (`batches` are the ones the loader
    hands over next), and reads each leaf's change from the snapshot.
    Returns (the readings, with no first gradient; the snapshot)."""
    sync()
    start = snapshot(trainer, config, batches[: ref.CHECK_STEPS])
    losses = []
    for k in range(ref.CHECK_STEPS):
        batch = next(trainer.loader)
        if not torch.equal(batch["label"].cpu(), torch.as_tensor(
                np.asarray(batches[k]["label"]))):
            raise RuntimeError("the loader's next batch is not the one "
                               "the pool holds next")
        losses.append(float(trainer.step(batch)))
    sync()
    readings = ref.Readings(
        losses=losses, grad_norms={},
        change_norms=change_norms(
            trainer.model, start.ids, start.dense,
            lambda i, block, lo, hi: start.rows[i][lo:hi]))
    return readings, start


class Trainer:
    """The training step and loader as main.py assembles them in device
    mode, over the run's pool of raw batches (cycled)."""

    def __init__(self, model: DLRMDCNv2, config: dict, pool: list[dict],
                 loss_fn: Callable | None = None) -> None:
        self.model = model
        self.optimizer = DenseAdagrad(model.parameters(),
                                      config["learning_rate"])
        self.step = make_train_step(
            model, loss_fn or ml_main.make_loss_fn(True), self.optimizer)
        self.loader = ThreadedDataLoader(
            itertools.cycle(pool), ml_main._raw,
            transfer_fn=model.to_device, num_workers=1)

    def stop(self) -> None:
        self.loader.stop()
