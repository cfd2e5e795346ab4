"""DistributedEmbedding: the user-facing stacked embedding layer.

Counterpart of keras_rs_tpu/layers/embedding/distributed_embedding.py:
any nest of feature configs (a dict, nested dicts, a list, one bare
config; activations come back in the same nest), per-table placement
("sharded" tables go to the stacked engine of lookup.py,
"default_device" tables to EmbedReduce; "auto" is sharded when the mesh
has more than one shard), table sharing by TableConfig identity, table
stacking ("auto", "never" or explicit groups, `table_stacking`) with or
without shard rotation (`shard_rotation`), COO preprocessing on the
host (`preprocess`, or `preprocess_host` + `to_device` where a loader
thread does the host part) or on the device (`preprocess_on_device`),
Ragged and sparse inputs, table import/export, input stats with capacity
growth (`auto_grow`, `record_stats`, `update_stats`,
`rebuild_capacities`), and the serving forms: `freeze()` (a slot-free `FrozenEmbedding`, f32 or
int8 in three layouts) and `serving_copy()` (a slot-free stacked twin).

Usage:
    layer = DistributedEmbedding(feature_configs, generator=g, device=dev)
    pre = layer.preprocess(inputs)   # host COO (numpy or C++), moved to
                                     # `dev`
    pre = layer.preprocess_on_device(device_inputs)  # the same, computed
                                     # on the device from device tensors
    activations = layer(pre)         # backward updates the stacked
                                     # tables in place (Overwrite contract)
    layer.apply_cotangents(pre, d_activations)  # the same update from a
                                     # cotangent computed elsewhere
                                     # (training/pipelined.py)

Sharded over D > 1 ranks (one process per device, torch.distributed; a
`mesh` of parallel/mesh.py, by default over every rank of the default
process group): each rank builds the layer with the same generator
seed, holds its shard of every stack (stacking.py), takes its B / D
samples of every feature and returns their activations. Preprocessing
runs on the device (`preprocess_on_device`: the rank's buckets go to
their shards in one all_to_all); the host `preprocess` needs the global
batch and raises. `get_embedding_tables` all-gathers the logical tables
and `set_embedding_tables` keeps each rank's rows. `comm_dtype=
"bfloat16"` sends the lookup's two [., dim] exchanges in bf16. At D > 1
`freeze()` all-gathers each table in row chunks and gives every rank
the FrozenEmbedding a one-device freeze of the same tables gives;
`serving_copy()` keeps each rank's shard (its table plane, copied, no
gather) in a slot-free twin on the same mesh.

Feature inputs are id arrays shaped as the feature declares, `Ragged`
batches (data/ragged.py) or sparse id matrices (data/sparse_utils.py),
densified to padded ids and 0/1 weights as in the JAX package: a Ragged
batch pads to its longest row, so a batch narrower than a feature's
valence takes the lookup's sorted forward (lookup.py). Inputs bind to
the features as a nest of the configs' structure, a flat dict keyed by
feature names, or, for a one-feature layer, a bare array.

Each stack's state is registered as buffers: `stack{i}_table` (the
packed [R, stride, dim] f32 state, or the split layout's [R, dim] table
in its storage dtype, f32 or bf16), `stack{i}_slot_{name}` for each
optimizer slot of a split stack ([R, dim] f32, or [R] f32 when
row-wise) and `stack{i}_step`, R the rows of this rank's shard;
`stack_state(i)` bundles them as the lookup takes them.
`stack{i}_layout` (int64, 0-dim) is the CRC-32 of the stack's table
order, offsets and rotations (so `shard_rotation` and `table_stacking`
change it): loading a state_dict whose layout differs, or that has none
(a checkpoint from before nests sorted their dict keys), raises instead
of restoring rows into the wrong tables.
Tables are exported and imported as logical [vocab, dim] tensors in the
storage dtype.

`get_config` / `from_config` round-trip the architecture (the tables and
features, the mesh axis names, table_stacking, dtype, auto_grow,
comm_dtype, shard_rotation); the values travel
through checkpoints (training/checkpoint.py: the stacks' buffers are in
the state_dict). Capacity growth rebuilds a stack's COO shapes only:
the tables, slots and step counters stay where they are.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import warnings
import zlib
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.convert import as_tensor
from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.data.ragged import Ragged
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    DeviceStats,
    preprocess_stack_device,
)
from keras_rs_tpu_torch.layers.embedding.embed_reduce import (
    EmbedReduce,
    QuantizedEmbedReduce,
    densify_inputs,
)
from keras_rs_tpu_torch.layers.embedding.optimizers import SGD
from keras_rs_tpu_torch.layers.embedding.lookup import (
    build_stack_state,
    merge_cotangents,
    split_activations,
    stack_lookup,
    stack_update,
)
from keras_rs_tpu_torch.layers.embedding.preprocessing import (
    CooBatch,
    InputStats,
    build_coo,
    preprocess_stack,
)
from keras_rs_tpu_torch.layers.embedding.stacking import (
    TableStack,
    build_stacks,
    scatter_table,
    shard_block,
    table_rows,
    unshard_table,
)
from keras_rs_tpu_torch.ops import quant
from keras_rs_tpu_torch.parallel import collectives, multihost
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.utils import tracing
from keras_rs_tpu_torch.utils.device import resolve_device, to_device

PREPROCESSED_KEY = "__keras_rs_tpu_preprocessed__"

# --- nests (the JAX package flattens feature configs with jax.tree_util:
# dict keys sorted, lists and tuples in order, None an empty node) -----
_LEAF = "*"


def flatten(tree: Any, is_leaf) -> tuple[list, Any]:
    """(leaves, structure) of a nest of dicts, lists and tuples, in
    jax.tree_util's order (dict keys sorted); `is_leaf(x)` ends the
    descent."""
    leaves: list = []
    return leaves, _walk(tree, is_leaf, leaves)


def unflatten(structure: Any, leaves: list) -> Any:
    """The nest of `structure` (from `flatten`) holding `leaves`."""
    return _build(structure, iter(leaves))


# Module-level recursion: a nested closure that calls itself is a
# reference cycle, which would keep the leaves (activations, and through
# their autograd nodes the stacked state) alive until a garbage
# collection.
def _walk(x: Any, is_leaf, leaves: list) -> Any:
    if is_leaf(x):
        leaves.append(x)
        return _LEAF
    if isinstance(x, Mapping):
        keys = sorted(x)
        return ("dict", tuple(keys),
                tuple(_walk(x[k], is_leaf, leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,
                tuple(_walk(v, is_leaf, leaves) for v in x))
    if x is None:
        return ("none",)
    leaves.append(x)
    return _LEAF


def _build(node: Any, it) -> Any:
    if node == _LEAF:
        return next(it)
    if node[0] == "dict":
        return {k: _build(c, it) for k, c in zip(node[1], node[2])}
    if node[0] == "none":
        return None
    items = [_build(c, it) for c in node[1]]
    return items if node[0] == "list" else tuple(items)


def _is_input_leaf(x: Any) -> bool:
    return x is None or isinstance(x, (np.ndarray, torch.Tensor, Ragged))


def _is_feature_config(x: Any) -> bool:
    return isinstance(x, FeatureConfig)


def flatten_features(feature_configs: Any) -> tuple[list, Any]:
    """(FeatureConfig leaves, structure); every leaf must be a
    FeatureConfig and feature names unique."""
    leaves, structure = flatten(feature_configs, _is_feature_config)
    for leaf in leaves:
        if not isinstance(leaf, FeatureConfig):
            raise ValueError(
                f"Expected FeatureConfig leaves, got {type(leaf)}."
            )
    names = [fc.name for fc in leaves]
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate feature names: {names}")
    return leaves, structure


def match_features(feature_leaves: list, structure: Any, inputs: Any,
                   allow_partial: bool = False) -> dict[str, Any]:
    """Binds an input nest to the features (by name):
      * a nest with exactly the feature configs' structure;
      * a flat dict keyed by feature names (with `allow_partial`, e.g.
        for weights, a subset);
      * a bare array for a one-feature layer.
    Anything else raises ValueError: a nest of another structure with the
    same number of leaves must never bind features to the wrong tables.
    """
    names = [fc.name for fc in feature_leaves]
    if isinstance(inputs, Mapping) and all(
            _is_input_leaf(v) for v in inputs.values()):
        unknown = set(inputs) - set(names)
        missing = set(names) - set(inputs)
        if not unknown and (not missing or allow_partial):
            return {name: inputs.get(name) for name in names}
        # Keys other than the feature names: a dict of the configs' own
        # structure (configs keyed "a" / "b", named "movie" / "user")
        # still binds below.
    leaves, got = flatten(inputs, _is_input_leaf)
    if got != structure and not (
            len(names) == 1 and len(leaves) == 1 and got == _LEAF):
        if isinstance(inputs, Mapping):
            unknown = set(inputs) - set(names)
            missing = set(names) - set(inputs)
            raise ValueError(
                "Feature inputs keyed by name do not match the layer's "
                f"features (unknown {sorted(unknown)}, missing "
                f"{sorted(missing)}) and their structure does not match "
                f"feature_configs either: expected {structure}, got {got}."
            )
        raise ValueError(
            "Feature inputs do not match the layer's feature_configs "
            f"structure. Expected {structure} (or a flat dict keyed by "
            f"feature names {names}), got {got}."
        )
    return dict(zip(names, leaves))


def coo_to_device(coo: CooBatch, device: Any) -> dict[str, torch.Tensor]:
    """The lookup's arrays of a CooBatch (host numpy arrays, or device
    tensors from preprocess_stack_device), flattened, on `device`: the
    construction-order forward's fwd_slots / fwd_gains where the batch
    has them, else the sorted forward's recv_slots. At D > 1 the
    received buffers are the rank's recv_* (at D = 1 the send buffers
    are what the one shard receives).

    Gather indices become int64 once per batch (on the device, so the
    host moves int32); `unique_slots` stays int32 for the row kernel.
    Host arrays go through pinned memory without waiting for the copy.
    """

    def put(a: np.ndarray | torch.Tensor) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = to_device(a, device)
        return a.reshape(-1).to(device)

    received = coo.recv_slots is not None
    out = {
        "recv_segs": put(coo.recv_segs if received
                         else coo.send_segs).long(),
        "recv_gains": put(coo.recv_gains if received else coo.send_gains),
        "entry_unique": put(coo.entry_unique).long(),
        "unique_slots": put(coo.unique_slots),
    }
    if coo.fwd_slots is None:
        out["recv_slots"] = put(coo.recv_slots if received
                                else coo.send_slots).long()
    else:
        out["fwd_slots"] = put(coo.fwd_slots).long()
        out["fwd_gains"] = put(coo.fwd_gains)
    return out


@export("keras_rs_tpu_torch.layers.DistributedEmbedding")
class DistributedEmbedding(nn.Module):
    def __init__(
        self,
        feature_configs: Any,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
        mesh: mesh_lib.Mesh | None = None,
        axis_name: mesh_lib.AxisName = mesh_lib.DATA_AXIS,
        table_stacking: Any = "auto",
        dtype: Any = "float32",
        auto_grow: bool = True,
        comm_dtype: str | None = None,
        shard_rotation: bool = True,
    ) -> None:
        super().__init__()
        self._feature_leaves, self._feature_structure = flatten_features(
            feature_configs)
        leaves = self._feature_leaves
        #: "auto", "never" or explicit groups of table names (stacking.py).
        self._table_stacking = (
            table_stacking if table_stacking is None
            or isinstance(table_stacking, str)
            else [list(g) for g in table_stacking])
        #: The JAX layer's state dtype, by name. Tables take their
        #: storage type from their TableConfig; the port keeps optimizer
        #: state in f32, so only "float32" is accepted.
        self._dtype_str = _dtype_name(dtype)
        if self._dtype_str != "float32":
            raise ValueError(
                f"dtype {self._dtype_str!r}: the stacked state is float32 "
                "(a TableConfig with dtype='bfloat16' stores that table in "
                "bf16)."
            )
        #: Rotated MOD sharding (stacking.py): table t of a stack starts
        #: at shard t % D. The layouts differ, so checkpoints of one do
        #: not load into the other (`stack{i}_layout`).
        self.shard_rotation = bool(shard_rotation)
        if comm_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"Unsupported comm_dtype: {comm_dtype!r} (use "
                "None/'float32' or 'bfloat16')."
            )
        #: "bfloat16" sends the lookup's reduce-scatter and all-gather in
        #: bf16 (D > 1; local sums stay f32).
        self.comm_dtype = comm_dtype
        #: When True, `preprocess(..., training=True)` (and
        #: `preprocess_on_device(..., training=True)`) merges the batch's
        #: stats across processes, grows every stack whose capacities
        #: it exceeded and redoes that stack: no id is dropped. False
        #: warns and drops (then `update_stats` / `rebuild_capacities`).
        self.auto_grow = bool(auto_grow)
        #: Held across a training pass's growth check, growth, redo and
        #: stats fold, so loader threads may preprocess with `training`.
        self._grow_lock = threading.Lock()
        if mesh is None:
            mesh = mesh_lib.create_mesh(device, axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self.device = (mesh.device if device is None
                       else resolve_device(device))
        #: Shards of every stack (the mesh axis's size), this rank's
        #: shard, and the axis's process group (None at D = 1).
        self.num_shards = mesh_lib.axis_size(mesh, axis_name)
        self.shard = mesh.index(axis_name)
        self._group = mesh.group(axis_name)

        # Placement: "auto" is sharded when the mesh has more than one
        # shard and default_device otherwise, as in the JAX package.
        def sharded(table: TableConfig) -> bool:
            if table.placement in ("sharded", "sparsecore"):
                return True
            return table.placement == "auto" and self.num_shards > 1

        sharded_fcs = [fc for fc in leaves if sharded(fc.table)]
        dense_fcs = [fc for fc in leaves if not sharded(fc.table)]

        self.stacks: tuple[TableStack, ...] = tuple(
            build_stacks(sharded_fcs, self.num_shards,
                         stacking=table_stacking,
                         shard_rotation=self.shard_rotation)
            if sharded_fcs else ()
        )
        table_configs = {fc.table.name: fc.table for fc in leaves}
        for i, stack in enumerate(self.stacks):
            state = build_stack_state(
                stack, table_configs, generator, self.device,
                shard=self.shard,
            )
            self.register_buffer(f"stack{i}_table", state["table"])
            for name, slot in state.get("slots", {}).items():
                self.register_buffer(f"stack{i}_slot_{name}", slot)
            self.register_buffer(f"stack{i}_step", state["step"])
            self.register_buffer(f"stack{i}_layout",
                                 _layout_code(stack, self.device))

        self.dense_tables = nn.ModuleDict()
        self._dense_feature_to_table: dict[str, str] = {}
        for fc in dense_fcs:
            t = fc.table
            self._dense_feature_to_table[fc.name] = t.name
            if t.name not in self.dense_tables:
                self.dense_tables[t.name] = EmbedReduce(
                    t.vocabulary_size,
                    t.embedding_dim,
                    generator=generator,
                    embeddings_initializer=t.initializer,
                    combiner=t.combiner,
                    device=self.device,
                    name=t.name,
                )
        #: Observed preprocessing stats by stack name (this process's).
        self._stats: dict[str, InputStats] = {}

    # ------------------------------------------------------------------
    def stack_state(self, i: int) -> dict[str, Any]:
        """Stack i's state as init_stack_state lays it out (the registered
        buffers themselves, updated in place): {"table", "step"}, and
        "slots" {name: tensor} for a split stack."""
        state = {
            "table": getattr(self, f"stack{i}_table"),
            "step": getattr(self, f"stack{i}_step"),
        }
        if not self.stacks[i].packed_state:
            state["slots"] = {
                name: getattr(self, f"stack{i}_slot_{name}")
                for name in self.stacks[i].optimizer.slot_names
            }
        return state

    def _match_features(self, structure: Any,
                        allow_partial: bool = False) -> dict[str, Any]:
        return match_features(self._feature_leaves, self._feature_structure,
                              structure, allow_partial)

    def _local_rows(self, fc: FeatureConfig) -> int:
        """This rank's rows of a feature's flattened batch."""
        return fc.batch_size // self.num_shards

    def _bind(self, inputs: Any, weights: Any, host: bool) -> tuple:
        """(ids, weights) by feature name, each shaped as its feature
        declares (this rank's rows at D > 1), leading axes flattened
        (weights None where not given): Ragged and sparse inputs
        densified, then numpy arrays (`host`) or tensors on the layer's
        device."""
        in_leaves = self._match_features(inputs)
        w_leaves = (
            self._match_features(weights, allow_partial=True)
            if weights is not None
            else {fc.name: None for fc in self._feature_leaves}
        )
        put = _to_host if host else (lambda a: _to(a, self.device))
        for fc in self._feature_leaves:
            ids, w = densify_inputs(in_leaves[fc.name], w_leaves[fc.name],
                                    fc.name)
            # A densified Ragged batch keeps its own width: narrower than
            # the valence, it takes the sorted forward.
            rows = self._local_rows(fc)
            target = (rows, -1) if fc.reduced else (rows,)
            in_leaves[fc.name] = put(ids).reshape(target)
            if w is not None:
                w_leaves[fc.name] = put(w).reshape(target)
        return in_leaves, w_leaves

    def _per_stack(self, in_leaves: dict, w_leaves: dict, stacks: tuple):
        """(stack, its features' ids, their given weights) per stack of
        `stacks`."""
        for stack in stacks:
            yield (
                stack,
                {f.name: in_leaves[f.name] for f in stack.features},
                {
                    f.name: w_leaves[f.name]
                    for f in stack.features
                    if w_leaves[f.name] is not None
                },
            )

    def _host_stacks(self, in_leaves, w_leaves, stacks, quiet=False):
        """Host COOs and stats of `stacks`; `quiet` drops ids over a
        capacity without the warning (the pass that growth redoes)."""
        build = build_coo if quiet else preprocess_stack
        coos, stats = {}, {}
        for stack, ids, w in self._per_stack(in_leaves, w_leaves, stacks):
            coos[stack.name], stats[stack.name] = build(stack, ids, w)
        return coos, stats

    def _device_stacks(self, in_leaves, w_leaves, stacks, quiet=False):
        """Device COOs and stats of `stacks` (the device transform never
        warns), each stack in a span "embedding.coo"; counts its id
        entries and dropped ids (utils/tracing.py)."""
        coos, stats = {}, {}
        for stack, ids, w in self._per_stack(in_leaves, w_leaves, stacks):
            with tracing.span("embedding.coo", stack=stack.name):
                coo, st = preprocess_stack_device(
                    stack, ids, w, shard=self.shard, group=self._group)
            coos[stack.name], stats[stack.name] = coo, st
            if tracing.enabled():
                tracing.count("embedding.ids",
                              sum(t.numel() for t in ids.values()))
                tracing.count("embedding.dropped_ids", st.dropped_ids)
        return coos, stats

    def _grow_and_fold(self, run, in_leaves, w_leaves, training: bool,
                       read=lambda st: st):
        """Runs `run(in_leaves, w_leaves, stacks, quiet)` (host or device
        stacks) on the bound inputs; in training with auto_grow, merges
        the stats across processes, grows the stacks whose capacities
        they exceed and runs those again (nothing of the batch is
        dropped, and the first pass warns of nothing); in training, folds
        this process's stats of the final pass. `read` turns a stack's
        stats into InputStats (a host read of DeviceStats).

        Safe on several threads: the first pass runs on the stacks as
        they were when it started, outside the layer's lock (numpy and
        the C++ engine release the interpreter lock); the growth check,
        the growth, the redo and the fold hold the lock. A pass that
        overflowed capacities another thread has grown since counts as
        exceeded (it dropped ids), so its stacks run again at the grown
        capacities, which its stats then leave as they are: capacities
        only rise."""
        grow = training and self.auto_grow and bool(self.stacks)
        coos, stats = run(in_leaves, w_leaves, self.stacks, grow)
        if not training:
            return coos, stats
        with self._grow_lock:
            if grow:
                grown = self._maybe_grow({k: read(v)
                                          for k, v in stats.items()})
                if grown:
                    new_coos, new_stats = run(
                        in_leaves, w_leaves,
                        tuple(s for s in self.stacks if s.name in grown))
                    coos.update(new_coos)
                    stats.update(new_stats)
            for name, st in stats.items():
                self._fold_stats(name, read(st))
        return coos, stats

    def _dense_inputs(self, in_leaves: dict, w_leaves: dict) -> dict:
        return {
            name: (in_leaves[name], w_leaves[name])
            for name in self._dense_feature_to_table
        }

    def preprocess_host(
        self, inputs: Any, weights: Any = None, training: bool = False
    ) -> dict[str, Any]:
        """Host-side COO preprocessing (the C++ engine where it builds,
        numpy otherwise), numpy arrays only: safe on loader threads, also
        with `training`, whose capacity growth (`auto_grow`) holds the
        layer's lock. A COO built before another thread's growth stays
        valid (the lookup takes its sizes from the COO's shapes). Pass
        the result through `to_device`. One process only: at D > 1 the
        host transform would need the global batch (use
        `preprocess_on_device`)."""
        if self.num_shards > 1:
            raise NotImplementedError(
                "The host COO preprocessing needs the global batch; a rank "
                "of a sharded layer holds its own samples: use "
                "preprocess_on_device (as the JAX ml_perf entry point "
                "does with more than one process)."
            )
        in_leaves, w_leaves = self._bind(inputs, weights, host=True)
        sharded, _ = self._grow_and_fold(self._host_stacks, in_leaves,
                                         w_leaves, training)
        return {PREPROCESSED_KEY: True, "sharded": sharded,
                "dense": self._dense_inputs(in_leaves, w_leaves)}

    def to_device(self, host_pre: dict[str, Any]) -> dict[str, Any]:
        """`preprocess_host`'s result on the layer's device, as
        `__call__` takes it."""
        sharded = {
            name: coo_to_device(coo, self.device)
            for name, coo in host_pre["sharded"].items()
        }
        dense = {
            name: (
                to_device(ids, self.device),
                None if w is None else to_device(w, self.device),
            )
            for name, (ids, w) in host_pre["dense"].items()
        }
        return {PREPROCESSED_KEY: True, "sharded": sharded, "dense": dense}

    def preprocess(
        self, inputs: Any, weights: Any = None, training: bool = False
    ) -> dict[str, Any]:
        """Host-side COO preprocessing; returns a marker-wrapped dict of
        device tensors to pass to `__call__`. With `training` and
        `auto_grow`, capacities grow so that no id is dropped."""
        return self.to_device(self.preprocess_host(inputs, weights,
                                                   training))

    def preprocess_on_device(
        self,
        inputs: Any,
        weights: Any = None,
        return_stats: bool = False,
        training: bool = False,
    ) -> Any:
        """COO preprocessing on the device, from id (and weight) tensors
        on the layer's device: the structure `preprocess` returns, with
        the same arrays, computed without a host round trip
        (device_preprocessing.py), so a training step can take raw ids.
        At D > 1 every rank calls it on its own samples (one all_to_all
        per stack).

        Shapes are static: without `training`, ids over a capacity are
        dropped without a warning. With `return_stats=True` also returns
        {stack name: DeviceStats} (0-d device tensors, this rank's); read
        them on the host now and then and pass them to `record_stats`.
        With `training` and `auto_grow` the stats are read on the host
        (one sync), merged across processes, and stacks over capacity
        grow and run again, as `preprocess` does.
        """
        with tracing.span("embedding.coo"):
            in_leaves, w_leaves = self._bind(inputs, weights, host=False)
            coos, stats = self._grow_and_fold(
                self._device_stacks, in_leaves, w_leaves, training,
                read=_host_stats)
            sharded = {name: coo_to_device(coo, self.device)
                       for name, coo in coos.items()}
            pre = {PREPROCESSED_KEY: True, "sharded": sharded,
                   "dense": self._dense_inputs(in_leaves, w_leaves)}
        return (pre, stats) if return_stats else pre

    # --- input stats and capacity growth ------------------------------
    def _fold_stats(self, stack_name: str, stats: InputStats) -> None:
        prev = self._stats.get(stack_name)
        if prev is None:
            self._stats[stack_name] = stats
        else:
            self._stats[stack_name] = InputStats(
                max_ids_per_bucket=max(prev.max_ids_per_bucket,
                                       stats.max_ids_per_bucket),
                max_unique_per_shard=max(prev.max_unique_per_shard,
                                         stats.max_unique_per_shard),
                dropped_ids=prev.dropped_ids + stats.dropped_ids,
            )

    @property
    def input_stats(self) -> dict[str, InputStats]:
        """Observed preprocessing stats by stack name (this process's;
        `update_stats` merges them across processes)."""
        return dict(self._stats)

    def record_stats(self, stats: Mapping[str, Any]) -> None:
        """Folds externally observed stats into the layer's stats:
        {stack name: InputStats | DeviceStats} (DeviceStats are read on
        the host here). For the device pipeline: pass the stats of
        `preprocess_on_device(..., return_stats=True)` now and then, then
        `update_stats()` / `rebuild_capacities()` work as on the host
        path."""
        for name, st in stats.items():
            self._fold_stats(name, _host_stats(st))

    def _maybe_grow(self, stats_by_stack: Mapping[str, InputStats]
                    ) -> set[str]:
        """Merges this batch's stats across processes and grows the
        stacks they exceed; returns the names of those stacks. Every
        process calls it on every training batch, so the merge is always
        matched and every process grows the same way."""
        flat: dict[str, int] = {}
        for name, st in stats_by_stack.items():
            flat[f"{name}\0ids"] = st.max_ids_per_bucket
            flat[f"{name}\0unique"] = st.max_unique_per_shard
            flat[f"{name}\0dropped"] = st.dropped_ids
        synced = multihost.sync_max_stats(
            flat, sum_keys=frozenset(k for k in flat
                                     if k.endswith("\0dropped")))
        merged = {
            name: InputStats(
                max_ids_per_bucket=synced[f"{name}\0ids"],
                max_unique_per_shard=synced[f"{name}\0unique"],
                dropped_ids=synced[f"{name}\0dropped"],
            )
            for name in stats_by_stack
        }
        exceeded = {
            stack.name for stack in self.stacks
            if stack.name in merged and _exceeds(stack, merged[stack.name])
        }
        if exceeded:
            self._grow_stacks(merged, only=exceeded)
        return exceeded

    def update_stats(self, warn: bool = True) -> dict[str, InputStats]:
        """The observed stats merged across processes (max of the
        capacity watermarks, sum of the drops), warning where they exceed
        a stack's capacities; then `rebuild_capacities(synced=...)`."""
        synced: dict[str, InputStats] = {}
        for stack in self.stacks:
            # Every process joins the merge of every stack: one that saw
            # no batch of it contributes zeros.
            st = self._stats.get(stack.name)
            agg = InputStats(**multihost.sync_max_stats(dataclasses.asdict(
                st if st is not None else InputStats(0, 0, 0))))
            if st is None and agg == InputStats(0, 0, 0):
                continue
            synced[stack.name] = agg
            if warn and _exceeds(stack, agg):
                warnings.warn(
                    f"Stack {stack.name!r}: observed stats exceed "
                    f"capacities (ids {agg.max_ids_per_bucket}/"
                    f"{stack.max_ids_per_partition}, unique "
                    f"{agg.max_unique_per_shard}/"
                    f"{stack.max_unique_ids_per_shard - 1}, dropped "
                    f"{agg.dropped_ids}). Call rebuild_capacities().",
                    stacklevel=2,
                )
        return synced

    def rebuild_capacities(
        self,
        margin: float = 1.25,
        synced: Mapping[str, InputStats] | None = None,
    ) -> bool:
        """Grows each stack's COO capacities to the observed maxima times
        `margin` (merged across processes; pass `synced`, e.g.
        `update_stats()`'s result, to skip the merge), at most to what a
        batch of the stack's shapes can fill. Only the preprocessed arrays'
        shapes change: tables, slots and step counters stay as they are.
        Returns whether anything changed."""
        if synced is None:
            synced = self.update_stats(warn=False)
        return self._grow_stacks(synced, margin=margin)

    def _grow_stacks(self, synced: Mapping[str, InputStats],
                     only: set[str] | None = None,
                     margin: float = 1.25) -> bool:
        changed = False
        new_stacks = []
        for stack in self.stacks:
            st = synced.get(stack.name)
            if st is None or (only is not None and stack.name not in only):
                new_stacks.append(stack)
                continue
            # A bucket holds at most one source's entries (its B / D
            # samples at their valences; more where a batch came wider
            # than its declared shape) and a shard at most D buckets:
            # growth stops there, where the JAX layer's margin sizes
            # past what any batch can fill (ROADMAP C4).
            most = max(stack.local_batch_size
                       * sum(f.valence for f in stack.features),
                       st.max_ids_per_bucket)
            C = max(stack.max_ids_per_partition,
                    min(int(math.ceil(st.max_ids_per_bucket * margin)),
                        most))
            U = max(stack.max_unique_ids_per_shard,
                    min(int(math.ceil(st.max_unique_per_shard * margin)),
                        stack.num_shards * most) + 1)
            if st.dropped_ids:
                # Entries dropped before the dedup make the observed
                # unique count an underestimate; a shard receives at most
                # D * C entries, so one rebuild converges.
                U = max(U, stack.num_shards * min(C, most) + 1)
            if (C, U) != (stack.max_ids_per_partition,
                          stack.max_unique_ids_per_shard):
                changed = True
                stack = dataclasses.replace(
                    stack, max_ids_per_partition=C,
                    max_unique_ids_per_shard=U)
            new_stacks.append(stack)
        self.stacks = tuple(new_stacks)
        return changed

    def graph_key(self) -> tuple[TableStack, ...]:
        """The plain state that shapes a training step's CUDA graph
        (training/train_state.StepGraph): the stacks, whose capacities
        size the device COO. A rebuild replaces them, and the next steps
        capture anew."""
        return self.stacks

    def has_sharded_tables(self) -> bool:
        """Whether any table resolved to the stacked (sharded) engine:
        with "auto" placement, true once the mesh has more than one
        shard."""
        return bool(self.stacks)

    # ------------------------------------------------------------------
    def forward(self, inputs: Any, weights: Any = None,
                training: bool = False) -> Any:
        """Looks up embeddings; accepts raw inputs (preprocessed here: on
        the host at D = 1, on the device at D > 1) or preprocessed ones.
        Returns the activations in the nest of the feature configs (this
        rank's rows at D > 1)."""
        if not (isinstance(inputs, dict) and PREPROCESSED_KEY in inputs):
            if self.num_shards > 1:
                inputs = self.preprocess_on_device(inputs, weights,
                                                   training=training)
            else:
                inputs = self.preprocess(inputs, weights, training)
        acts_by_name: dict[str, torch.Tensor] = {}
        for i, stack in enumerate(self.stacks):
            acts = stack_lookup(
                stack, self.stack_state(i), inputs["sharded"][stack.name],
                self._group, self.comm_dtype,
            )
            acts_by_name.update(split_activations(stack, acts))
        for name, (ids, w) in inputs["dense"].items():
            table = self.dense_tables[self._dense_feature_to_table[name]]
            acts_by_name[name] = table(ids, w)

        outs = []
        for fc in self._feature_leaves:
            act = acts_by_name[fc.name]
            lead = tuple(fc.output_shape[:-1])
            out_shape = ((lead[0] // self.num_shards,) + lead[1:]
                         + (act.shape[-1],))
            outs.append(act.reshape(out_shape))
        return unflatten(self._feature_structure, outs)

    def apply_cotangents(self, pre: dict[str, Any], d_acts: Any) -> None:
        """The training update of a lookup from its activations'
        cotangent alone: what the backward of `self(pre)` does, without
        running the forward again (the JAX pipelined step's vjp,
        training/pipelined.py).

        `pre` is the preprocessed batch the activations were gathered for
        and `d_acts` their cotangents, in the nest of `forward`'s output
        or keyed by feature name (None counts as zero). Each stack takes
        its features' cotangents in its segment layout
        (`lookup.merge_cotangents`) and updates its state in place
        (`stack_update`: the fused optimizer, the step counter). The
        dense-placement tables run their lookup through autograd, so
        their gradients accumulate in `.grad` for the dense optimizer.
        """
        d_by_name = self._match_features(d_acts, allow_partial=True)
        for i, stack in enumerate(self.stacks):
            stack_update(stack, self.stack_state(i),
                         pre["sharded"][stack.name],
                         merge_cotangents(stack, d_by_name, self.device),
                         self._group, self.comm_dtype)
        outs, grads = [], []
        with torch.enable_grad():
            for name, (ids, w) in pre["dense"].items():
                if d_by_name[name] is None:
                    continue
                act = self.dense_tables[self._dense_feature_to_table[name]](
                    ids, w)
                outs.append(act)
                grads.append(d_by_name[name].reshape(act.shape).to(act.dtype))
            if outs:
                torch.autograd.backward(outs, grads)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def get_embedding_tables(self) -> dict[str, torch.Tensor]:
        """Unstacked [vocab, dim] tables by name (copies, in the storage
        dtype). At D > 1 every rank must call it: each table's shards
        are all-gathered in chunks of GATHER_CHUNK_ROWS rows, and every
        rank gets the whole table."""
        configs = {fc.table.name: fc.table for fc in self._feature_leaves}
        return {name: _whole_table(rows_of, configs[name], self.device)
                for name, rows_of in _table_rows_sources(self).items()}

    @torch.no_grad()
    def set_embedding_tables(
        self, tables: Mapping[str, np.ndarray | torch.Tensor]
    ) -> None:
        """Writes [vocab, dim] values into the stacked state (table rows
        only, rounded to nearest in a bf16 table; optimizer slots are
        untouched; at D > 1 this rank's rows) and the dense tables. numpy
        arrays may be bf16 (ml_dtypes, as the JAX package exports a bf16
        table)."""
        for i, stack in enumerate(self.stacks):
            table = self.stack_state(i)["table"]
            for ts in stack.tables:
                if ts.name in tables:
                    scatter_table(
                        stack, table, ts.name, as_tensor(tables[ts.name]),
                        shard=self.shard if stack.num_shards > 1 else None,
                    )
        for name, layer in self.dense_tables.items():
            if name in tables:
                layer.embeddings.copy_(as_tensor(tables[name]))

    # ------------------------------------------------------------------
    def freeze(self, quantize: str | None = None) -> "FrozenEmbedding":
        """Inference-only snapshot: each table once, without optimizer
        slots, looked up with plain gathers and combiner reductions (no
        COO preprocessing), on the layer's device.

        `quantize="int8"` stores each table int8 with per-row scales
        (ops/quant.py): 4x less memory than f32 at <= absmax/254 per
        element. "int8_packed" and "int8_fused" keep the same values in
        the JAX package's packed layouts. An int8 freeze quantizes table
        by table in row chunks straight from the stacked state, so it
        needs the int8 tables and one chunk beside the training state.

        At D > 1 every rank must call it: each table's shards are
        all-gathered table by table in chunks of `GATHER_CHUNK_ROWS`
        logical rows (only table planes cross, never slots), and
        every rank gets the FrozenEmbedding that a one-device freeze of
        the same logical tables gives, bit for bit (its whole tables,
        not shards).
        """
        return FrozenEmbedding(self, quantize=quantize)

    @torch.no_grad()
    def serving_copy(self) -> "DistributedEmbedding":
        """A slot-free twin for inference through the normal `preprocess`
        + forward path: the same stack grouping and row layout, the
        slot-free SGD optimizer, and each stack's table rows (the packed
        state's table plane) copied into new storage, so the copy keeps
        only table bytes and shares no stacked storage with this layer;
        its step counters are copies too. `default_device` tables share
        this layer's EmbedReduce modules. Training the copy would train
        plain SGD from the copied tables.

        At D > 1 the copy is on the same mesh and axis, and each rank
        copies its own shard's table plane: nothing is gathered. It
        serves through `preprocess_on_device` + forward like this layer.
        """
        sgd_tables: dict[str, TableConfig] = {}

        def to_sgd(t: TableConfig) -> TableConfig:
            if t.name not in sgd_tables:
                sgd_tables[t.name] = dataclasses.replace(t, optimizer="sgd")
            return sgd_tables[t.name]

        new = DistributedEmbedding.__new__(DistributedEmbedding)
        nn.Module.__init__(new)
        new._feature_leaves = [
            dataclasses.replace(fc, table=to_sgd(fc.table))
            for fc in self._feature_leaves
        ]
        new._feature_structure = self._feature_structure
        for attr in ("device", "mesh", "axis_name", "num_shards", "shard",
                     "_group", "comm_dtype", "auto_grow", "_dtype_str",
                     "shard_rotation"):
            setattr(new, attr, getattr(self, attr))
        new._stats = {}
        new._grow_lock = threading.Lock()
        # The old grouping, pinned: regrouping by the new optimizer could
        # merge stacks and change their row layouts.
        new._table_stacking = [[t.name for t in s.tables]
                               for s in self.stacks] or "never"
        new.stacks = tuple(
            dataclasses.replace(s, optimizer=SGD(), packed_state=False)
            for s in self.stacks
        )
        for i, stack in enumerate(self.stacks):
            state = self.stack_state(i)
            table = state["table"]
            table = table[:, 0] if stack.packed_state else table
            new.register_buffer(
                f"stack{i}_table",
                table.clone(memory_format=torch.contiguous_format))
            new.register_buffer(f"stack{i}_step", state["step"].clone())
            new.register_buffer(f"stack{i}_layout",
                                _layout_code(stack, new.device))
        new.dense_tables = nn.ModuleDict(dict(self.dense_tables))
        new._dense_feature_to_table = dict(self._dense_feature_to_table)
        return new

    def _load_from_state_dict(self, state_dict, prefix, *args) -> None:
        """Refuses a state whose stacks hold their tables in another
        order (see `stack{i}_layout`) before any row is copied."""
        for i, stack in enumerate(self.stacks):
            key = f"{prefix}stack{i}_layout"
            want = int(_layout_code(stack))
            got = state_dict.get(key)
            if got is None or int(got) != want:
                raise ValueError(
                    f"The state for {key} has another stack layout "
                    f"({'none' if got is None else int(got)}, this layer "
                    f"{want}: tables {[t.name for t in stack.tables]}); "
                    "its rows would land in other tables."
                )
        super()._load_from_state_dict(state_dict, prefix, *args)

    def get_config(self) -> dict[str, Any]:
        """The tables (shared tables once, by index), the features, and
        the mesh axis names, table_stacking, dtype, auto_grow, comm_dtype
        and shard_rotation, as the JAX package's config holds them.
        Table values come from a checkpoint, not from the config."""
        tables: list[TableConfig] = []
        table_index: dict[int, int] = {}
        features = []
        for fc in self._feature_leaves:
            if id(fc.table) not in table_index:
                table_index[id(fc.table)] = len(tables)
                tables.append(fc.table)
            features.append({
                "name": fc.name,
                "table_index": table_index[id(fc.table)],
                "input_shape": tuple(fc.input_shape),
                "output_shape": tuple(fc.output_shape),
            })
        axis_name = self.axis_name
        return {
            "tables": [t.get_config() for t in tables],
            "features": features,
            "axis_name": (list(axis_name) if isinstance(axis_name, tuple)
                          else axis_name),
            "table_stacking": self._table_stacking,
            "dtype": self._dtype_str,
            "auto_grow": self.auto_grow,
            "comm_dtype": self.comm_dtype,
            "shard_rotation": self.shard_rotation,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "DistributedEmbedding":
        """Rebuilds the layer with its features as a list (tables shared
        as the config shares them), as the JAX package does; `config`
        may add `generator`, `device` and `mesh` (runtime state; by
        default a mesh over the ranks with the config's axis names)."""
        tables = [TableConfig.from_config(c) for c in config["tables"]]
        fcs = [
            FeatureConfig(
                name=f["name"], table=tables[f["table_index"]],
                input_shape=tuple(f["input_shape"]),
                output_shape=tuple(f["output_shape"]))
            for f in config["features"]
        ]
        axis_name = config.get("axis_name", mesh_lib.DATA_AXIS)
        if isinstance(axis_name, list):
            axis_name = tuple(axis_name)
        return cls(fcs, generator=config.get("generator"),
                   device=config.get("device"), mesh=config.get("mesh"),
                   axis_name=axis_name,
                   table_stacking=config.get("table_stacking", "auto"),
                   dtype=config.get("dtype", "float32"),
                   auto_grow=config.get("auto_grow", True),
                   comm_dtype=config.get("comm_dtype"),
                   shard_rotation=config.get("shard_rotation", True))


def _layout_code(stack: TableStack, device: Any = "cpu") -> torch.Tensor:
    """CRC-32 of the stack's table order, local offsets and rotations,
    as a 0-dim int64 tensor (the layout a checkpoint must match)."""
    text = ";".join(f"{t.name}@{t.local_offset}r{t.rotation}"
                    for t in stack.tables)
    return torch.tensor(zlib.crc32(f"{stack.name}:{text}".encode()),
                        dtype=torch.int64, device=device)


def _dtype_name(dtype: Any) -> str:
    """"float32" for torch.float32, np.float32 or "float32" (the JAX
    layer's `np.dtype(dtype).name`)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def _exceeds(stack: TableStack, st: InputStats) -> bool:
    return (st.max_ids_per_bucket > stack.max_ids_per_partition
            or st.max_unique_per_shard > stack.max_unique_ids_per_shard - 1
            or st.dropped_ids > 0)


def _host_stats(st: InputStats | DeviceStats) -> InputStats:
    """InputStats of host ints (DeviceStats are read from the device, in
    a span "host_sync")."""
    if isinstance(st, InputStats):
        return st
    with tracing.span("host_sync", site="device_stats"):
        return InputStats(max_ids_per_bucket=int(st.max_ids_per_bucket),
                          max_unique_per_shard=int(st.max_unique_per_shard),
                          dropped_ids=int(st.dropped_ids))


def _to_host(a: Any) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to(a: Any, device: torch.device) -> torch.Tensor:
    """A tensor on `device` (a tensor already there is not copied)."""
    if isinstance(a, np.ndarray):
        return to_device(a, device)
    return torch.as_tensor(a, device=device)


QUANTIZE_LAYOUTS = {None: None, "int8": "rows", "int8_packed": "packed",
                    "int8_fused": "fused"}


class FrozenEmbedding(nn.Module):
    """Slot-free inference view of a `DistributedEmbedding`
    (`DistributedEmbedding.freeze()`).

    Takes the same raw feature structures as the training layer (id
    arrays or tensors, Ragged, sparse) and returns the same activations,
    in the nest of its feature configs, computed with one `EmbedReduce` (f32)
    or `QuantizedEmbedReduce` (int8) per table: features that share a
    table share its module and its tensors. The batch axis is free: a
    feature declared (B, L) also takes (b, L') for any b (and any L'),
    so requests of any batch size are served; other axes are as
    declared. Every module step is a device op on tensors, with no host
    read, so the forward can be captured in a CUDA graph
    (serving.aot_compile) once its inputs are tensors on the device.
    """

    def __init__(self, layer: DistributedEmbedding,
                 quantize: str | None = None) -> None:
        super().__init__()
        if quantize not in QUANTIZE_LAYOUTS:
            raise ValueError(
                f"Unsupported `quantize`: {quantize!r} (use None, "
                "'int8', 'int8_packed', or 'int8_fused')."
            )
        layout = QUANTIZE_LAYOUTS[quantize]
        self._feature_leaves = list(layer._feature_leaves)
        self._feature_structure = layer._feature_structure
        self.device = layer.device
        tables = {fc.table.name: fc.table for fc in self._feature_leaves}
        reducers = {}
        if layout is None:
            values = layer.get_embedding_tables()
            for name, t in tables.items():
                reducers[name] = EmbedReduce(
                    t.vocabulary_size, t.embedding_dim, table=values[name],
                    combiner=t.combiner, name=name,
                )
        else:
            rows_of = _table_rows_sources(layer)
            for name, t in tables.items():
                # Only dim-128 tables fuse; the others keep "rows", as in
                # the JAX package.
                fits = layout != "fused" or t.embedding_dim == 128
                reducers[name] = _quantized_reducer(
                    rows_of[name], t, layout if fits else "rows",
                    self.device)
        #: One module per table, in `table_names` order (a ModuleList:
        #: table names need not be valid attribute names), and the same
        #: modules by feature name.
        self.table_names = list(reducers)
        self.table_reducers = nn.ModuleList(reducers.values())
        self._reducers = {
            fc.name: reducers[fc.table.name] for fc in self._feature_leaves
        }

    @property
    def tables(self) -> dict[str, torch.Tensor]:
        """Logical [vocab, dim] f32 table per table name (export view;
        dequantized for int8)."""
        return {name: er.embeddings
                for name, er in zip(self.table_names, self.table_reducers)}

    def _match_features(self, structure: Any,
                        allow_partial: bool = False) -> dict[str, Any]:
        return match_features(self._feature_leaves, self._feature_structure,
                              structure, allow_partial)

    def forward(self, inputs: Any, weights: Any = None) -> Any:
        in_leaves = self._match_features(inputs)
        w_leaves = (
            self._match_features(weights, allow_partial=True)
            if weights is not None
            else {fc.name: None for fc in self._feature_leaves}
        )
        outs = []
        for fc in self._feature_leaves:
            ids, w = densify_inputs(in_leaves[fc.name], w_leaves[fc.name],
                                    fc.name)
            ids = _to(ids, self.device)
            b = ids.shape[0]
            rows = b * (fc.batch_size // fc.input_shape[0])
            target = (rows, ids.shape[-1]) if fc.reduced else (rows,)
            act = self._reducers[fc.name](
                ids.reshape(target),
                None if w is None else _to(w, self.device).reshape(target),
            )
            outs.append(act.reshape(
                (b,) + tuple(fc.output_shape[1:-1]) + (act.shape[-1],)))
        return unflatten(self._feature_structure, outs)


#: Logical rows per chunk of get_embedding_tables and freeze (512 MB
#: of f32 at dim 128): at D > 1 one all_gather each, every rank sending
#: 1 / D of them.
GATHER_CHUNK_ROWS = 1 << 20


def _table_rows_sources(layer: DistributedEmbedding) -> dict:
    """{table name: rows_of(lo, hi)}, rows [lo, hi) of each table of the
    layer (stacked or dense) in its storage dtype, read without a copy of
    the whole table. At D > 1 a call is collective: every rank must make
    the same calls in the same order."""
    out = {}
    for i, stack in enumerate(layer.stacks):
        state_table = layer.stack_state(i)["table"]
        for ts in stack.tables:
            if stack.num_shards == 1:
                out[ts.name] = (
                    lambda lo, hi, stack=stack, n=ts.name, t=state_table:
                    table_rows(stack, t, n, lo, hi)
                )
            else:
                out[ts.name] = (
                    lambda lo, hi, stack=stack, n=ts.name, t=state_table:
                    _gathered_rows(stack, t, n, lo, hi, layer._group)
                )
    for name, er in layer.dense_tables.items():
        out[name] = lambda lo, hi, e=er: e.embeddings.detach()[lo:hi]
    return out


def _gathered_rows(stack: TableStack, state_table: torch.Tensor,
                   table_name: str, lo: int, hi: int, group) -> torch.Tensor:
    """Logical rows [lo, hi) of a table sharded over D ranks (a
    collective): each rank sends the local rows that hold rows [lo, hi)
    of its shard, one all_gather stacks them, `unshard_table`
    interleaves them."""
    D = stack.num_shards
    block = shard_block(stack, state_table, table_name)[lo // D : -(-hi // D)]
    blocks = collectives.all_gather(block, group).view(D, *block.shape)
    return unshard_table(stack, table_name, blocks, lo, hi)


def _whole_table(rows_of, table: TableConfig,
                 device: torch.device) -> torch.Tensor:
    """A table's [vocab, dim] rows in its storage dtype (a copy),
    assembled from `rows_of` in chunks of GATHER_CHUNK_ROWS rows."""
    V = table.vocabulary_size
    out = None
    for lo in range(0, V, GATHER_CHUNK_ROWS):
        rows = rows_of(lo, min(V, lo + GATHER_CHUNK_ROWS))
        if out is None:
            out = torch.empty((V, table.embedding_dim), dtype=rows.dtype,
                              device=device)
        out[lo : lo + rows.shape[0]] = rows
    return out


@torch.no_grad()
def _quantized_reducer(rows_of, table: TableConfig, layout: str,
                       device: torch.device) -> QuantizedEmbedReduce:
    """One table quantized chunk by chunk into int8 and scales on
    `device`, wrapped in its layout."""
    V, dim = table.vocabulary_size, table.embedding_dim
    q = torch.empty((V, dim), dtype=torch.int8, device=device)
    scale = torch.empty((V, 1), dtype=torch.float32, device=device)
    quant.quantize_rows_int8_into(rows_of, V, q, scale)
    return QuantizedEmbedReduce(q, scale, combiner=table.combiner,
                                name=table.name, layout=layout)
