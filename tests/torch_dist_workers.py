"""Ranks of keras_rs_tpu_torch for the tests: gloo process groups of
spawned CPU processes, and what each rank runs. This module imports no
JAX (the ranks import it), and holds no test.

`Pools` keeps one `RankPool` per world size for a test module: its D
processes join one gloo group once and then run many cases, each a
function of this module called on every rank as fn(rank, world,
**kwargs), whose results come back by rank. Every case has its own
timeout: a case that fails or hangs kills the pool's processes (the next
case spawns a new pool), so one hang fails one test.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback
from typing import Any

import numpy as np

CASE_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 10.0
READY_TIMEOUT_S = 60.0
#: Spawns of a pool before its module's test fails: a free port found by
#: binding to 0 can be taken by another process before the group binds it.
SPAWN_ATTEMPTS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, conn) -> None:
    """A rank's loop: join the group, then run cases until told to
    stop."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.pop("WORLD_SIZE", None)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    conn.send(("ready", None))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", globals()[name](rank, world, **kwargs)))
            except BaseException:  # reported to the test, which fails
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankPool:
    """`world` spawned ranks in one gloo group."""

    def __init__(self, world: int) -> None:
        self.world = world
        for attempt in range(SPAWN_ATTEMPTS):
            self._spawn()
            if self._ready():
                return
            self.kill()
        raise RuntimeError(f"{world} ranks did not join a gloo group in "
                           f"{SPAWN_ATTEMPTS} attempts")

    def _spawn(self) -> None:
        ctx = mp.get_context("spawn")
        port = _free_port()
        self._conns, self._procs = [], []
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve,
                            args=(rank, self.world, port, child),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    def _ready(self) -> bool:
        """Whether every rank joined the group within READY_TIMEOUT_S."""
        for conn in self._conns:
            try:
                if not (conn.poll(READY_TIMEOUT_S)
                        and conn.recv() == ("ready", None)):
                    return False
            except (EOFError, OSError):
                return False
        return True

    def run(self, name: str, timeout: float = CASE_TIMEOUT_S,
            **kwargs) -> list:
        """`name(rank, world, **kwargs)` on every rank; its results by
        rank. A rank that raises, or no answer within `timeout`, kills
        the pool and raises here."""
        for conn in self._conns:
            conn.send((name, kwargs))
        out, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout):
                self.kill()
                raise TimeoutError(f"{name}: rank {rank} gave no answer in "
                                   f"{timeout} s")
            status, value = conn.recv()
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
                # The others may wait in a collective for this rank.
                timeout = min(timeout, JOIN_TIMEOUT_S)
            out.append(value)
        if errors:
            self.kill()
            raise RuntimeError(f"{name} failed:\n" + "\n".join(errors))
        return out

    def alive(self) -> bool:
        return all(p.is_alive() for p in self._procs)

    def kill(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(JOIN_TIMEOUT_S)
        self._procs = []

    def close(self) -> None:
        for conn, p in zip(self._conns, self._procs):
            if p.is_alive():
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self._procs:
            p.join(JOIN_TIMEOUT_S)
        self.kill()
        assert not any(p.is_alive() for p in self._procs)


class Pools:
    """One RankPool per world size, spawned at first use."""

    def __init__(self) -> None:
        self._pools: dict[int, RankPool] = {}

    def __call__(self, world: int) -> RankPool:
        pool = self._pools.get(world)
        if pool is None or not pool._procs or not pool.alive():
            pool = self._pools[world] = RankPool(world)
        return pool

    def close(self) -> None:
        for pool in self._pools.values():
            pool.close()
        self._pools.clear()


# --- what the ranks run -----------------------------------------------

def _mesh(world: int, axes=("data",), sizes=None):
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib

    if len(axes) == 1:
        return mesh_lib.create_mesh("cpu", axes[0])
    return mesh_lib.create_mesh("cpu", tuple(axes), sizes)


def _tables_from_spec(spec: list[dict]):
    """Port TableConfigs of a list of {"name", "vocab", "dim", ...}."""
    from keras_rs_tpu_torch.layers.embedding.config import TableConfig

    return {
        t["name"]: TableConfig(
            name=t["name"], vocabulary_size=t["vocab"],
            embedding_dim=t["dim"],
            optimizer=t.get("optimizer", "sgd"),
            combiner=t.get("combiner", "sum"),
            placement=t.get("placement", "sharded"),
            dtype=t.get("dtype", "float32"),
            max_ids_per_partition=t.get("max_ids", 64),
            max_unique_ids_per_partition=t.get("max_unique", 64),
        )
        for t in spec
    }


def feature_configs(tables: list[dict], features: list[dict],
                    nest: str = "dict"):
    """Port FeatureConfigs of a spec: features [{"name", "table",
    "input_shape", "output_shape"}], as a dict keyed by name or a
    list."""
    from keras_rs_tpu_torch.layers.embedding.config import FeatureConfig

    by_name = _tables_from_spec(tables)
    fcs = [FeatureConfig(name=f["name"], table=by_name[f["table"]],
                         input_shape=tuple(f["input_shape"]),
                         output_shape=tuple(f["output_shape"]))
           for f in features]
    return fcs if nest == "list" else {fc.name: fc for fc in fcs}


def _local(arrays: dict | None, rank: int, world: int) -> dict | None:
    """This rank's rows of each global array."""
    if arrays is None:
        return None
    out = {}
    for k, v in arrays.items():
        n = v.shape[0] // world
        out[k] = v[rank * n : (rank + 1) * n]
    return out


def _torch_tree(arrays: dict | None):
    import torch

    if arrays is None:
        return None
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def _numpy(t) -> np.ndarray:
    import torch

    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.detach().cpu().numpy()


def coo_case(rank: int, world: int, tables, features, inputs,
             weights=None) -> dict:
    """The rank's device COO of the stack(s) of `tables` at D = world:
    its send rows, what it received, its dedup, its stats."""
    import torch.distributed as dist

    from keras_rs_tpu_torch.layers.embedding import device_preprocessing
    from keras_rs_tpu_torch.layers.embedding.stacking import build_stacks

    fcs = list(feature_configs(tables, features).values())
    stacks = build_stacks(fcs, world)
    ids = _torch_tree(_local(inputs, rank, world))
    w = _torch_tree(_local(weights, rank, world))
    out = {}
    for stack in stacks:
        coo, st = device_preprocessing.preprocess_stack_device(
            stack, {f.name: ids[f.name] for f in stack.features},
            None if w is None else {f.name: w[f.name]
                                    for f in stack.features if f.name in w},
            shard=rank, group=dist.group.WORLD)
        out[stack.name] = {
            **{k: _numpy(v) for k, v in coo.arrays().items()},
            "stats": [int(x) for x in st],
        }
    return out


def build_layer(world: int, tables, features, seed: int = 0, nest="dict",
                axes=("data",), sizes=None, **kwargs):
    import torch

    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )

    mesh = _mesh(world, axes, sizes)
    return DistributedEmbedding(
        feature_configs(tables, features, nest),
        generator=torch.Generator().manual_seed(seed), device="cpu",
        mesh=mesh, axis_name=axes[0] if len(axes) == 1 else tuple(axes),
        **kwargs)


def layer_case(rank: int, world: int, tables, features, inputs,
               logical=None, weights=None, steps: int = 0,
               comm_dtype=None, axes=("data",), sizes=None,
               seed: int = 0) -> dict:
    """A D = world layer (logical tables from `logical` where given):
    this rank's activations, then `steps` training steps of the loss
    sum over features of mean(act ** 2) over the global batch, the loss
    of each, and the all-gathered logical tables after them."""
    import torch

    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    layer = build_layer(world, tables, features, seed=seed, axes=axes,
                        sizes=sizes, comm_dtype=comm_dtype)
    if logical is not None:
        layer.set_embedding_tables(logical)
    ids = _torch_tree(_local(inputs, rank, world))
    w = _torch_tree(_local(weights, rank, world))
    pre = layer.preprocess_on_device(ids, w)
    with torch.no_grad():
        acts = {k: _numpy(v) for k, v in layer(pre).items()}

    def loss_fn(m, p):
        return sum((v.float() ** 2).mean() for v in m(p).values())

    step = make_train_step(layer, loss_fn,
                           DenseAdagrad(layer.parameters(), 0.1),
                           mesh=layer.mesh)
    losses = [float(step(pre)) for _ in range(steps)]
    return {
        "acts": acts,
        "losses": losses,
        "tables": {k: _numpy(v)
                   for k, v in layer.get_embedding_tables().items()},
        "num_shards": layer.num_shards,
        "shard": layer.shard,
        "has_sharded_tables": layer.has_sharded_tables(),
        "local_tables": [_numpy(layer.stack_state(i)["table"])
                         for i in range(len(layer.stacks))],
    }


def rotation_case(rank: int, world: int, tables, features, values,
                  seed: int = 0) -> dict:
    """Row placement: the rank's local tables after set_embedding_tables
    of `values`, the all-gathered tables, and (before the set) the
    logical tables the initializer drew."""
    layer = build_layer(world, tables, features, seed=seed)
    drawn = {k: _numpy(v) for k, v in layer.get_embedding_tables().items()}
    layer.set_embedding_tables(values)
    return {
        "drawn": drawn,
        "local": [_numpy(layer.stack_state(i)["table"])
                  for i in range(len(layer.stacks))],
        "gathered": {k: _numpy(v)
                     for k, v in layer.get_embedding_tables().items()},
        "rows_per_shard": [s.rows_per_shard for s in layer.stacks],
    }


def autogrow_case(rank: int, world: int, tables, features, inputs,
                  auto_grow: bool, training: bool,
                  ones_table: str | None = None) -> dict:
    """One preprocess_on_device of the rank's rows (with `training`):
    the stacks' capacities before and after, the merged stats, and the
    activations with an all-ones table where `ones_table` names it."""
    import warnings

    import torch

    layer = build_layer(world, tables, features, nest="list",
                        auto_grow=auto_grow)
    before = [(s.max_ids_per_partition, s.max_unique_ids_per_shard)
              for s in layer.stacks]
    ids = _torch_tree(_local(inputs, rank, world))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pre = layer.preprocess_on_device(ids, training=training)
        merged = layer.update_stats(warn=False)
    out = {
        "before": before,
        "after": [(s.max_ids_per_partition, s.max_unique_ids_per_shard)
                  for s in layer.stacks],
        "local_stats": {k: list(v.__dict__.values())
                        for k, v in layer.input_stats.items()},
        "merged_stats": {k: list(v.__dict__.values())
                         for k, v in merged.items()},
        "warnings": [str(w.message) for w in caught],
    }
    if ones_table is not None:
        vocab = next(t["vocab"] for t in tables if t["name"] == ones_table)
        dim = next(t["dim"] for t in tables if t["name"] == ones_table)
        layer.set_embedding_tables({ones_table: np.ones((vocab, dim),
                                                        np.float32)})
        with torch.no_grad():
            out["acts"] = [_numpy(v) for v in layer(pre)]
    return out


def record_stats_case(rank: int, world: int, tables, features,
                      records: list) -> dict:
    """Rank r records records[r] (a list of (ids, unique, dropped)
    DeviceStats); the merged stats, the update_stats warning and the
    capacities rebuild_capacities gives."""
    import warnings

    import torch

    from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
        DeviceStats,
    )

    layer = build_layer(world, tables, features, nest="list",
                        auto_grow=False)
    name = layer.stacks[0].name
    for rec in records[rank]:
        layer.record_stats({name: DeviceStats(
            *(torch.tensor(x, dtype=torch.int32) for x in rec))})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        synced = layer.update_stats()
    changed = layer.rebuild_capacities(synced=synced)
    return {
        "merged": list(synced[name].__dict__.values()),
        "warnings": [str(w.message) for w in caught],
        "changed": changed,
        "capacities": (layer.stacks[0].max_ids_per_partition,
                       layer.stacks[0].max_unique_ids_per_shard),
    }


def rebuild_case(rank: int, world: int, tables, features, inputs) -> dict:
    """tests/test_parity_features.py:89 at D = world: drops with
    auto_grow off, update_stats warns, rebuild_capacities grows, the
    next batch drops nothing and gives finite activations."""
    import warnings

    import torch

    layer = build_layer(world, tables, features, nest="list",
                        auto_grow=False)
    ids = _torch_tree(_local(inputs, rank, world))
    layer.preprocess_on_device(ids, training=True)
    old_c = layer.stacks[0].max_ids_per_partition
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        layer.update_stats()
    changed = layer.rebuild_capacities()
    pre, stats = layer.preprocess_on_device(ids, return_stats=True)
    with torch.no_grad():
        acts = [_numpy(v) for v in layer(pre)]
    return {
        "old_c": old_c,
        "new": (layer.stacks[0].max_ids_per_partition,
                layer.stacks[0].max_unique_ids_per_shard),
        "changed": changed,
        "warnings": [str(w.message) for w in caught],
        "dropped_after": [int(s.dropped_ids) for s in stats.values()],
        "acts": acts,
    }


def dlrm_case(rank: int, world: int, config: dict, params: dict,
              tables: dict, batches: list, seed: int = 0) -> dict:
    """The port's DLRM at D = world with the given parameters and
    logical tables: one data-parallel step on the rank's rows of each
    of `batches` (device COO); the losses, the dense parameters and the
    logical tables after them, and the dense parameters as built from
    `seed` (before the given ones are loaded)."""
    import torch

    from keras_rs_tpu_torch import convert
    from keras_rs_tpu_torch.models import dlrm
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    mesh = _mesh(world)
    model = dlrm.DLRMDCNv2(dlrm.DLRMConfig(**config),
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu", mesh=mesh)
    built = {k: _numpy(p).copy() for k, p in model.named_parameters()}
    convert.load_params(model, params, tables)
    opt = DenseAdagrad(model.parameters(), config["learning_rate"])

    def loss_fn(m, b):
        return dlrm.bce_loss(m, m.preprocess_on_device(b))

    step = make_train_step(model, loss_fn, opt, mesh=mesh)
    losses = [float(step(_torch_tree(_local(b, rank, world))))
              for b in batches]
    return {
        "built": built,
        "losses": losses,
        "params": {k: _numpy(p) for k, p in model.named_parameters()},
        "tables": {k: _numpy(v) for k, v in
                   model.embedding_layer.get_embedding_tables().items()},
    }


def weak_scaling_case(rank: int, world: int, per_device_batch: int,
                      comm_dtype: str | None) -> dict:
    """The port's weak-scaling tool's counted training step on this rank
    (keras_rs_tpu_torch/tools/weak_scaling.py): its collective bytes by
    kind, FLOPs and loss."""
    from keras_rs_tpu_torch.tools import weak_scaling

    return weak_scaling.counted_step(rank, world, per_device_batch,
                                     comm_dtype, device="cpu")


#: The torch.distributed function each collective kind calls.
COLLECTIVE_CALLS = {
    "all-to-all": "all_to_all_single",
    "reduce-scatter": "reduce_scatter_tensor",
    "all-gather": "all_gather_into_tensor",
    "all-reduce": "all_reduce",
    "broadcast": "broadcast",
}


def traced_exchange_case(rank: int, world: int,
                         per_device_batch: int) -> dict:
    """The weak-scaling tool's training step on this rank with tracing
    on: the calls of each torch.distributed collective while it ran,
    its collective spans as (name, bytes, step id), the tracing
    counters and count_bytes' bytes by kind."""
    import torch.distributed as dist

    from keras_rs_tpu_torch.tools import weak_scaling
    from keras_rs_tpu_torch.utils import tracing

    calls = dict.fromkeys(COLLECTIVE_CALLS, 0)
    originals = {}

    def counting(kind, fn):
        def call(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return call

    for kind, name in COLLECTIVE_CALLS.items():
        originals[name] = getattr(dist, name)
        setattr(dist, name, counting(kind, originals[name]))
    tracing.reset()
    tracing.enable()
    try:
        out = weak_scaling.counted_step(rank, world, per_device_batch,
                                        device="cpu")
        spans = [(s.name, s.attrs.get("bytes"), s.step)
                 for s in tracing.spans() if s.name.startswith("collective")]
        counters = tracing.counters()
    finally:
        tracing.disable()
        tracing.reset()
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return {"calls": calls, "spans": spans, "counters": counters,
            "per_kind": out["per_kind"]}


def mlperf_case(rank: int, world: int, overrides: dict) -> Any:
    """The ml_perf entry point on this rank (the pool's group is the
    run's process group); its results dict, or the NotImplementedError
    it raised, as a string."""
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    try:
        return mlperf.main("smoke_test", device="cpu", **overrides)
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"


def parallel_case(rank: int, world: int) -> dict:
    """parallel/'s helpers on this rank: the mesh's shard index, rows
    and groups, put_batch, replicate, and the multihost helpers."""
    import torch
    import torch.distributed as dist

    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.parallel import multihost

    mesh = mesh_lib.create_mesh("cpu")
    rows = mesh_lib.batch_rows(mesh, 4 * world)
    put = mesh_lib.put_batch(mesh, {"x": np.arange(4 * world),
                                    "y": [np.arange(2 * world)]})
    w = {"w": torch.full((3,), float(rank)), "v": [torch.tensor([rank])]}
    mesh_lib.replicate(mesh, w)
    out = {
        "index": mesh.index("data"),
        "rows": (rows.start, rows.stop),
        "put_x": put["x"].tolist(),
        "put_y": put["y"][0].tolist(),
        "replicated": (w["w"].tolist(), w["v"][0].tolist()),
        "allgather": multihost.process_allgather(
            np.asarray([rank, 10 * rank])).tolist(),
        "stats": multihost.sync_max_stats(
            {"max_ids": rank + 1, "dropped_ids": rank + 2}),
        "process": (multihost.process_index(), multihost.process_count()),
        "host": multihost.global_batch_from_host_shards(
            mesh, {"x": np.full(2, rank)})["x"].tolist(),
    }
    if world == 4:
        two = mesh_lib.create_mesh("cpu", ("model", "data"), (2, 2))
        out["two"] = {
            "index": two.index(("model", "data")),
            "model": two.index("model"),
            "data": two.index("data"),
            "world_group": two.group(("model", "data")) is dist.group.WORLD,
            "data_group_size": dist.get_world_size(two.group("data")),
        }
    return out


# --- the sharded path's second half: retrieval, pipelined step,
# checkpoints, serving forms, data-parallel training -------------------

def retrieval_case(rank: int, world: int, cands, queries, k: int,
                   ids=None, update_without_ids: bool = False) -> dict:
    """ShardedBruteForceRetrieval over the world's ranks: the top-k
    scores and rows (or ids), the rank's block and the config; with
    `update_without_ids`, the error of an update that drops the ids."""
    import torch

    from keras_rs_tpu_torch.parallel.sharded_retrieval import (
        ShardedBruteForceRetrieval,
    )

    layer = ShardedBruteForceRetrieval(cands, candidate_ids=ids, k=k,
                                       mesh=_mesh(world))
    scores, top = layer(torch.from_numpy(queries))
    out = {"scores": _numpy(scores), "top": _numpy(top),
           "block": _numpy(layer.candidate_embeddings),
           "config": layer.get_config(),
           "rows_per_shard": layer.rows_per_shard}
    layer.return_scores = False
    out["top_only"] = _numpy(layer(torch.from_numpy(queries)))
    if update_without_ids:
        try:
            layer.update_candidates(cands)
            out["error"] = None
        except ValueError as e:
            out["error"] = str(e)
    return out


def _dlrm_model(world: int, config: dict, params: dict, tables=None,
                states=None, seed: int = 0):
    import torch

    from keras_rs_tpu_torch import convert
    from keras_rs_tpu_torch.models import dlrm

    mesh = _mesh(world)
    model = dlrm.DLRMDCNv2(dlrm.DLRMConfig(**config),
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu", mesh=mesh)
    convert.load_params(model, params, tables, states)
    return model, mesh


def _dlrm_out(model, losses) -> dict:
    return {
        "losses": losses,
        "params": {k: _numpy(p) for k, p in model.named_parameters()},
        "tables": {k: _numpy(v) for k, v in
                   model.embedding_layer.get_embedding_tables().items()},
        "steps": [int(model.embedding_layer.stack_state(i)["step"])
                  for i in range(len(model.embedding_layer.stacks))],
    }


def pipelined_case(rank: int, world: int, config: dict, params: dict,
                   batches: list, tables=None, states=None,
                   pipelined: bool = True) -> dict:
    """The port's DLRM at D = world (device COO, the ml_perf entry
    point's pipeline functions): one pipelined step per batch, each
    prefetching the next batch's rows (the last its own), or with
    `pipelined=False` one plain data-parallel step per batch; the
    losses, the dense parameters and the logical tables after them."""
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models import dlrm
    from keras_rs_tpu_torch.training import pipelined as pipelining
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    model, mesh = _dlrm_model(world, config, params, tables, states)
    opt = DenseAdagrad(model.parameters(), config["learning_rate"])
    local = [model.to_device(_local(b, rank, world)) for b in batches]
    if not pipelined:
        step = make_train_step(model, mlperf.make_loss_fn(True), opt,
                               mesh=mesh)
        return _dlrm_out(model, [float(step(b)) for b in local])
    embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
    state = pipelining.create_pipelined_train_state(
        model, opt, get_pre(local[0]), embed_fn)
    step = pipelining.make_pipelined_train_step(
        dlrm.bce_loss, opt, embed_fn, get_pre, inject, mesh=mesh)
    losses = []
    for t, b in enumerate(local):
        nxt = local[min(t + 1, len(local) - 1)]
        losses.append(float(step(state, b, get_pre(nxt))[1]))
    out = _dlrm_out(model, losses)
    out["state_step"] = state.step
    return out


def checkpoint_case(rank: int, world: int, config: dict, params: dict,
                    tables: dict, batches: list, directory: str) -> dict:
    """Sharded checkpoints of a pipelined DLRM at D = world: two steps
    and a CheckpointManager save of step 2 (committed by
    wait_until_finished), a restore into a fresh model of other weights
    (compared bit for bit: every parameter and buffer, the dense
    optimizer), then one more step of both, each re-primed from batch 2
    as a resumed loop does."""
    import os

    import torch

    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models import dlrm
    from keras_rs_tpu_torch.training import checkpoint
    from keras_rs_tpu_torch.training import pipelined as pipelining
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad

    def build(seed, logical):
        model, mesh = _dlrm_model(world, config, params, logical, seed=seed)
        opt = DenseAdagrad(model.parameters(), config["learning_rate"])
        local = [model.to_device(_local(b, rank, world)) for b in batches]
        embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
        state = pipelining.create_pipelined_train_state(
            model, opt, get_pre(local[0]), embed_fn)
        step = pipelining.make_pipelined_train_step(
            dlrm.bce_loss, opt, embed_fn, get_pre, inject, mesh=mesh)
        return state, step, local, embed_fn, get_pre

    sa, step_a, la, embed_fn, get_pre = build(0, tables)
    for t in range(2):
        step_a(sa, la[t], get_pre(la[t + 1]))
    mgr = checkpoint.CheckpointManager(directory, max_to_keep=2)
    mgr.save(2, sa)
    mgr.wait_until_finished()
    sb, step_b, lb, _, _ = build(5, {k: v * 3 for k, v in tables.items()})
    mgr.restore(None, sb)
    equal = {k: torch.equal(v, sa.model.state_dict()[k])
             for k, v in sb.model.state_dict().items()}
    equal["optimizer"] = all(
        torch.equal(x, y) for x, y in zip(sa.optimizer.accumulators,
                                          sb.optimizer.accumulators))
    sa.prefetched = pipelining.prime(sa.model, get_pre(la[2]), embed_fn)
    sb.prefetched = pipelining.prime(sb.model, get_pre(lb[2]), embed_fn)
    next_a = float(step_a(sa, la[2], get_pre(la[3]))[1])
    next_b = float(step_b(sb, lb[2], get_pre(lb[3]))[1])
    after = [sa.model.state_dict(), sb.model.state_dict()]
    mgr.close()
    return {
        "latest": mgr.latest_step(), "step": sb.step, "equal": equal,
        "next": (next_a, next_b),
        "after_equal": all(torch.equal(v, after[1][k])
                           for k, v in after[0].items()),
        "files": sorted(os.listdir(os.path.join(directory, "step_2"))),
    }


def layer_checkpoint_case(rank: int, world: int, tables, features,
                          path: str, save: bool, seed: int = 0,
                          steps: int = 0, manager: bool = False,
                          **kwargs) -> dict:
    """A DistributedEmbedding at D = world (layer `kwargs`): with `save`
    it takes `steps` steps of sum(act^2) on fixed ids and is saved to
    `path` (save_checkpoint; with `manager`, a CheckpointManager save
    after every step); else a layer of another seed restores from `path`
    (the manager's latest step). Returns its all-gathered tables, step
    counters and local tables, or the error the restore raised."""
    import torch

    from keras_rs_tpu_torch.training import checkpoint
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    layer = build_layer(world, tables, features, seed=seed, **kwargs)
    state = {"layer": layer}
    if save:
        rng = np.random.default_rng(seed)
        ids = {f["name"]: rng.integers(
            0, next(t["vocab"] for t in tables if t["name"] == f["table"]),
            f["input_shape"]) for f in features}
        pre = layer.preprocess_on_device(_torch_tree(_local(ids, rank,
                                                            world)))
        step = make_train_step(
            layer, lambda m, p: sum((v ** 2).mean() for v in m(p).values()),
            DenseAdagrad(layer.parameters(), 0.1), mesh=layer.mesh)
        if manager:
            mgr = checkpoint.CheckpointManager(path, max_to_keep=2)
            for s in range(1, steps + 1):
                step(pre)
                mgr.save(s, state)
            mgr.close()
        else:
            for _ in range(steps):
                step(pre)
            checkpoint.save_checkpoint(path, state)
    else:
        try:
            if manager:
                checkpoint.CheckpointManager(path).restore(None, state)
            else:
                checkpoint.restore_checkpoint(path, state)
        except (ValueError, FileNotFoundError) as e:
            return {"error": f"{type(e).__name__}: {e}"}
    return {
        "tables": {k: _numpy(v)
                   for k, v in layer.get_embedding_tables().items()},
        "steps": [int(layer.stack_state(i)["step"])
                  for i in range(len(layer.stacks))],
        "local": [_numpy(layer.stack_state(i)["table"])
                  for i in range(len(layer.stacks))],
    }


def serving_case(rank: int, world: int, tables, features, logical: dict,
                 inputs: dict, quantize: list, **kwargs) -> dict:
    """freeze() and serving_copy() of a D = world layer holding the
    `logical` tables: each freeze's tensors and its forward on the
    global `inputs` (every rank serves the whole batch), and the serving
    copy's forward on the rank's rows against the layer's own, with what
    it holds."""
    import torch

    layer = build_layer(world, tables, features, **kwargs)
    layer.set_embedding_tables(logical)
    ids = _torch_tree(inputs)
    out = {"frozen": {}}
    with torch.no_grad():
        for q in quantize:
            frozen = layer.freeze(quantize=q)
            out["frozen"][str(q)] = {
                "state": {k: _numpy(v)
                          for k, v in frozen.state_dict().items()},
                "acts": {k: _numpy(v) for k, v in frozen(ids).items()},
            }
        copy = layer.serving_copy()
        local = _torch_tree(_local(inputs, rank, world))
        want = layer(layer.preprocess_on_device(local))
        got = copy(copy.preprocess_on_device(local))
    buffers = dict(copy.named_buffers())
    trained = {id(t) for t in layer.buffers()}
    ptrs = {t.data_ptr() for t in layer.buffers()}
    out["copy"] = {
        "equal": all(torch.equal(got[k], want[k]) for k in want),
        "buffers": sorted(buffers),
        "shared": any(id(t) in trained or t.data_ptr() in ptrs
                      for k, t in buffers.items() if "table" in k),
        "optimizers": [s.optimizer.name for s in copy.stacks],
        "num_shards": copy.num_shards,
        "stacking": copy.get_config()["table_stacking"],
        "rotation": copy.shard_rotation,
        "local": [_numpy(copy.stack_state(i)["table"])
                  for i in range(len(copy.stacks))],
    }
    return out


def placement_case(rank: int, world: int, tables, features, values: dict,
                   states=None, **kwargs) -> dict:
    """A D = world layer with layer `kwargs` (table_stacking,
    shard_rotation): its stacks, its local tables after
    set_embedding_tables(values), those of its from_config rebuild, and,
    with `states` (the JAX layer's, through convert.load_params), its
    local tables after loading them or the error the load raised."""
    from keras_rs_tpu_torch import convert
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )

    layer = build_layer(world, tables, features, **kwargs)
    layer.set_embedding_tables(values)
    config = layer.get_config()
    rebuilt = DistributedEmbedding.from_config(dict(
        config, device="cpu", mesh=layer.mesh))
    rebuilt.set_embedding_tables(values)
    out = {
        "stacks": [[(t.name, t.local_offset, t.rotation) for t in s.tables]
                   for s in layer.stacks],
        "rebuilt_stacks": [[(t.name, t.local_offset, t.rotation)
                            for t in s.tables] for s in rebuilt.stacks],
        "config": {k: v for k, v in config.items()
                   if k in ("table_stacking", "dtype", "shard_rotation")},
        "local": [_numpy(layer.stack_state(i)["table"])
                  for i in range(len(layer.stacks))],
        "rebuilt_local": [_numpy(rebuilt.stack_state(i)["table"])
                          for i in range(len(rebuilt.stacks))],
    }
    if states is not None:
        fresh = build_layer(world, tables, features, seed=9, **kwargs)
        try:
            convert.load_params(fresh, {}, states=states)
            out["loaded"] = [_numpy(fresh.stack_state(i)["table"])
                             for i in range(len(fresh.stacks))]
        except ValueError as e:
            out["loaded"] = str(e)
    return out


def data_parallel_case(rank: int, world: int, params: dict,
                       epochs: int) -> dict:
    """examples/data_parallel_retrieval.py at D = world from `params`,
    and Trainer(mesh=) fed the same global batches cut by put_batch
    instead of prefetch_sharding (the loss of each epoch)."""
    import torch

    from keras_rs_tpu_torch import convert
    from keras_rs_tpu_torch.data import synthetic
    from keras_rs_tpu_torch.examples import data_parallel_retrieval as ex
    from keras_rs_tpu_torch.models.two_tower import (
        TwoTower,
        in_batch_softmax_loss,
    )
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad
    from keras_rs_tpu_torch.training.trainer import Trainer

    res = ex.main(device="cpu", epochs=epochs, params=params)
    mesh = _mesh(world)
    model = TwoTower(ex.NUM_USERS, ex.NUM_ITEMS, 32, device="cpu")
    convert.load_params(model, params)
    fb = synthetic.implicit_feedback(
        num_users=ex.NUM_USERS, num_items=ex.NUM_ITEMS, num_events=40_960,
        seed=0)
    train = {"user_id": fb["user_id"], "item_id": fb["item_id"]}
    trainer = Trainer(
        model, DenseAdagrad(model.parameters(), 0.5),
        lambda m, b: in_batch_softmax_loss(m, b["user_id"], b["item_id"],
                                           mesh=mesh), mesh=mesh)
    hist = trainer.fit(
        lambda: (mesh_lib.put_batch(mesh, b) for b in synthetic.batches(
            train, ex.BATCH, seed=1)), epochs=epochs, log_every=0)
    return {"example": res, "put_batch_loss": hist["loss"],
            "kernel": torch.cat([p.detach().reshape(-1)
                                 for p in model.parameters()]).numpy()}


def ann_case(rank: int, world: int, num_candidates: int) -> dict:
    """examples/ann_retrieval.py at D = world: each engine's ids and
    recall."""
    from keras_rs_tpu_torch.examples import ann_retrieval

    res = ann_retrieval.main(num_candidates=num_candidates, device="cpu")
    return {k: {"ids": v["ids"], "recall": v["recall"]}
            for k, v in res.items()}


def dryrun_case(rank: int, world: int) -> dict:
    from keras_rs_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(world, "cpu")


def mlperf_log_case(rank: int, world: int, overrides: dict) -> tuple:
    """The ml_perf entry point on this rank: (its results, the messages
    it logged)."""
    import logging

    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    messages: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    log = logging.getLogger("ml_perf")
    handler, level = Keep(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        res = mlperf.main("smoke_test", device="cpu", **overrides)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return res, "\n".join(messages)
