"""DistributedEmbedding: the user-facing stacked embedding layer (D = 1).

Counterpart of keras_rs_tpu/layers/embedding/distributed_embedding.py on
one device: per-table placement ("sharded" tables go to the stacked
engine of lookup.py, "default_device" tables to EmbedReduce), table
sharing by TableConfig identity, auto table stacking, COO preprocessing
on the host (`preprocess`, or `preprocess_host` + `to_device` where a
loader thread does the host part) or on the device
(`preprocess_on_device`), Ragged and sparse inputs, table import/export,
and the serving forms: `freeze()` (a slot-free `FrozenEmbedding`, f32 or
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

Feature inputs are id arrays shaped as the feature declares, `Ragged`
batches (data/ragged.py) or sparse id matrices (data/sparse_utils.py),
densified to padded ids and 0/1 weights as in the JAX package: a Ragged
batch pads to its longest row, so a batch narrower than a feature's
valence takes the lookup's sorted forward (lookup.py).

Each stack's state is registered as buffers: `stack{i}_table` (the
packed [R, stride, dim] f32 state, or the split layout's [R, dim] table
in its storage dtype, f32 or bf16), `stack{i}_slot_{name}` for each
optimizer slot of a split stack ([R, dim] f32, or [R] f32 when
row-wise) and `stack{i}_step`; `stack_state(i)` bundles them as the
lookup takes them. Tables are exported and imported as logical
[vocab, dim] tensors in the storage dtype.

`get_config` / `from_config` round-trip the architecture (the tables and
features); the values travel through checkpoints (training/checkpoint.py:
the stacks' buffers are in the state_dict). Not ported yet:
multi-device sharding, stats tracking and capacity growth
(`record_stats` / `update_stats`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.convert import as_tensor
from keras_rs_tpu_torch.core.serialization import export
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
    init_stack_state,
    merge_cotangents,
    split_activations,
    stack_lookup,
    stack_update,
)
from keras_rs_tpu_torch.layers.embedding.preprocessing import (
    CooBatch,
    preprocess_stack,
)
from keras_rs_tpu_torch.layers.embedding.stacking import (
    TableStack,
    build_stacks,
    gather_table,
    init_stack_table,
    scatter_table,
    table_rows,
)
from keras_rs_tpu_torch.ops import quant
from keras_rs_tpu_torch.utils.device import resolve_device, to_device

PREPROCESSED_KEY = "__keras_rs_tpu_preprocessed__"


def coo_to_device(coo: CooBatch, device: Any) -> dict[str, torch.Tensor]:
    """The D = 1 lookup's arrays of a CooBatch (host numpy arrays, or
    device tensors from preprocess_stack_device), flattened, on `device`:
    the construction-order forward's fwd_slots / fwd_gains where the
    batch has them, else the sorted forward's recv_slots.

    Gather indices become int64 once per batch (on the device, so the
    host moves int32); `unique_slots` stays int32 for the row kernel.
    Host arrays go through pinned memory without waiting for the copy.
    """

    def put(a: np.ndarray | torch.Tensor) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = to_device(a, device)
        return a.reshape(-1).to(device)

    out = {
        "recv_segs": put(coo.send_segs).long(),
        "recv_gains": put(coo.send_gains),
        "entry_unique": put(coo.entry_unique).long(),
        "unique_slots": put(coo.unique_slots),
    }
    if coo.fwd_slots is None:
        out["recv_slots"] = put(coo.send_slots).long()
    else:
        out["fwd_slots"] = put(coo.fwd_slots).long()
        out["fwd_gains"] = put(coo.fwd_gains)
    return out


@export("keras_rs_tpu_torch.layers.DistributedEmbedding")
class DistributedEmbedding(nn.Module):
    def __init__(
        self,
        feature_configs: Mapping[str, FeatureConfig],
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        self._keys = list(feature_configs)
        leaves = list(feature_configs.values())
        for leaf in leaves:
            if not isinstance(leaf, FeatureConfig):
                raise ValueError(
                    f"Expected FeatureConfig values, got {type(leaf)}."
                )
        names = [fc.name for fc in leaves]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate feature names: {names}")
        self._feature_leaves = leaves
        self.device = resolve_device(device)

        # Placement on one device: "auto" resolves to default_device,
        # as in the JAX package with a one-device mesh.
        def sharded(table: TableConfig) -> bool:
            return table.placement in ("sharded", "sparsecore")

        sharded_fcs = [fc for fc in leaves if sharded(fc.table)]
        dense_fcs = [fc for fc in leaves if not sharded(fc.table)]

        self.stacks: tuple[TableStack, ...] = tuple(
            build_stacks(sharded_fcs, 1)
        )
        table_configs = {fc.table.name: fc.table for fc in leaves}
        for i, stack in enumerate(self.stacks):
            table = init_stack_table(
                stack, table_configs, generator, self.device
            )
            state = init_stack_state(stack, table)
            del table
            self.register_buffer(f"stack{i}_table", state["table"])
            for name, slot in state.get("slots", {}).items():
                self.register_buffer(f"stack{i}_slot_{name}", slot)
            self.register_buffer(f"stack{i}_step", state["step"])

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

    def _match_features(
        self, structure: Mapping[str, Any], allow_partial: bool = False
    ) -> dict[str, Any]:
        """Binds a mapping keyed like feature_configs to feature names
        (`allow_partial`: missing keys, e.g. of weights, give None)."""
        unknown = set(structure) - set(self._keys)
        missing = set(self._keys) - set(structure)
        if unknown or (missing and not allow_partial):
            raise ValueError(
                "Feature inputs do not match the layer's features: unknown "
                f"{sorted(unknown)}, missing {sorted(missing)}."
            )
        return {
            fc.name: structure.get(k)
            for k, fc in zip(self._keys, self._feature_leaves)
        }

    def _bind(self, inputs: Any, weights: Any, host: bool) -> tuple:
        """(ids, weights) by feature name, each shaped as its feature
        declares, leading axes flattened (weights None where not given):
        Ragged and sparse inputs densified, then numpy arrays (`host`) or
        tensors on the layer's device."""
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
            target = (
                (fc.batch_size, -1) if fc.reduced else (fc.batch_size,)
            )
            in_leaves[fc.name] = put(ids).reshape(target)
            if w is not None:
                w_leaves[fc.name] = put(w).reshape(target)
        return in_leaves, w_leaves

    def _per_stack(self, in_leaves: dict, w_leaves: dict):
        """(stack, its features' ids, their given weights) per stack."""
        for stack in self.stacks:
            yield (
                stack,
                {f.name: in_leaves[f.name] for f in stack.features},
                {
                    f.name: w_leaves[f.name]
                    for f in stack.features
                    if w_leaves[f.name] is not None
                },
            )

    def preprocess_host(
        self, inputs: Any, weights: Any = None
    ) -> dict[str, Any]:
        """Host-side COO preprocessing (the C++ engine where it builds,
        numpy otherwise), numpy arrays only: safe on a loader thread. Pass
        the result through `to_device`."""
        in_leaves, w_leaves = self._bind(inputs, weights, host=True)
        sharded = {
            stack.name: preprocess_stack(stack, ids, w)[0]
            for stack, ids, w in self._per_stack(in_leaves, w_leaves)
        }
        dense = {
            name: (in_leaves[name], w_leaves[name])
            for name in self._dense_feature_to_table
        }
        return {PREPROCESSED_KEY: True, "sharded": sharded, "dense": dense}

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
        self, inputs: Any, weights: Any = None
    ) -> dict[str, Any]:
        """Host-side COO preprocessing; returns a marker-wrapped dict of
        device tensors to pass to `__call__`."""
        return self.to_device(self.preprocess_host(inputs, weights))

    def preprocess_on_device(
        self,
        inputs: Any,
        weights: Any = None,
        return_stats: bool = False,
    ) -> Any:
        """COO preprocessing on the device, from id (and weight) tensors
        on the layer's device: the structure `preprocess` returns, with
        the same arrays, computed without a host round trip
        (device_preprocessing.py), so a training step can take raw ids.

        Shapes are static: ids over a capacity are dropped without a
        warning. With `return_stats=True` also returns {stack name:
        DeviceStats} (0-d device tensors); read `dropped_ids` on the host
        now and then to see drops.
        """
        in_leaves, w_leaves = self._bind(inputs, weights, host=False)
        sharded = {}
        stats: dict[str, DeviceStats] = {}
        for stack, ids, w in self._per_stack(in_leaves, w_leaves):
            coo, stats[stack.name] = preprocess_stack_device(stack, ids, w)
            sharded[stack.name] = coo_to_device(coo, self.device)
        dense = {
            name: (in_leaves[name], w_leaves[name])
            for name in self._dense_feature_to_table
        }
        pre = {PREPROCESSED_KEY: True, "sharded": sharded, "dense": dense}
        return (pre, stats) if return_stats else pre

    def forward(self, inputs: Any, weights: Any = None) -> Any:
        """Looks up embeddings; accepts raw inputs or preprocessed ones.
        Returns the activations keyed like feature_configs."""
        if not (isinstance(inputs, dict) and PREPROCESSED_KEY in inputs):
            inputs = self.preprocess(inputs, weights)
        acts_by_name: dict[str, torch.Tensor] = {}
        for i, stack in enumerate(self.stacks):
            acts = stack_lookup(
                stack, self.stack_state(i), inputs["sharded"][stack.name]
            )
            acts_by_name.update(split_activations(stack, acts))
        for name, (ids, w) in inputs["dense"].items():
            table = self.dense_tables[self._dense_feature_to_table[name]]
            acts_by_name[name] = table(ids, w)

        outs = []
        for fc in self._feature_leaves:
            act = acts_by_name[fc.name]
            out_shape = tuple(fc.output_shape[:-1]) + (act.shape[-1],)
            outs.append(act.reshape(out_shape))
        return dict(zip(self._keys, outs))

    def apply_cotangents(self, pre: dict[str, Any],
                         d_acts: Mapping[str, Any]) -> None:
        """The training update of a lookup from its activations'
        cotangent alone: what the backward of `self(pre)` does, without
        running the forward again (the JAX pipelined step's vjp,
        training/pipelined.py).

        `pre` is the preprocessed batch the activations were gathered for
        and `d_acts` their cotangents, keyed like `forward`'s output (None
        counts as zero). Each stack takes its features' cotangents in its
        segment layout (`lookup.merge_cotangents`) and updates its state
        in place (`stack_update`: the fused optimizer, the step counter). The dense-placement tables run
        their lookup through autograd, so their gradients accumulate in
        `.grad` for the dense optimizer.
        """
        d_by_name = {fc.name: d_acts[k]
                     for k, fc in zip(self._keys, self._feature_leaves)}
        for i, stack in enumerate(self.stacks):
            stack_update(stack, self.stack_state(i),
                         pre["sharded"][stack.name],
                         merge_cotangents(stack, d_by_name, self.device))
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
        dtype)."""
        out = {}
        for i, stack in enumerate(self.stacks):
            table = self.stack_state(i)["table"]
            for ts in stack.tables:
                out[ts.name] = gather_table(stack, table, ts.name)
        for name, layer in self.dense_tables.items():
            out[name] = layer.embeddings.detach().clone()
        return out

    @torch.no_grad()
    def set_embedding_tables(
        self, tables: Mapping[str, np.ndarray | torch.Tensor]
    ) -> None:
        """Writes [vocab, dim] values into the stacked state (table rows
        only, rounded to nearest in a bf16 table; optimizer slots are
        untouched) and the dense tables. numpy arrays may be bf16
        (ml_dtypes, as the JAX package exports a bf16 table)."""
        for i, stack in enumerate(self.stacks):
            table = self.stack_state(i)["table"]
            for ts in stack.tables:
                if ts.name in tables:
                    scatter_table(
                        stack, table, ts.name, as_tensor(tables[ts.name])
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
        """
        sgd_tables: dict[str, TableConfig] = {}

        def to_sgd(t: TableConfig) -> TableConfig:
            if t.name not in sgd_tables:
                sgd_tables[t.name] = dataclasses.replace(t, optimizer="sgd")
            return sgd_tables[t.name]

        new = DistributedEmbedding.__new__(DistributedEmbedding)
        nn.Module.__init__(new)
        new._keys = list(self._keys)
        new._feature_leaves = [
            dataclasses.replace(fc, table=to_sgd(fc.table))
            for fc in self._feature_leaves
        ]
        new.device = self.device
        # The old grouping, pinned: regrouping by the new optimizer could
        # merge stacks and change their row layouts.
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
        new.dense_tables = nn.ModuleDict(dict(self.dense_tables))
        new._dense_feature_to_table = dict(self._dense_feature_to_table)
        return new

    def get_config(self) -> dict[str, Any]:
        """The tables (shared tables once, by index) and the features, as
        the JAX package's config holds them; its mesh entries (axis_name,
        table_stacking, dtype, auto_grow, comm_dtype, shard_rotation)
        have no counterpart on one device. Table values come from a
        checkpoint, not from the config."""
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
        return {"tables": [t.get_config() for t in tables],
                "features": features}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "DistributedEmbedding":
        """Rebuilds the layer (features keyed by name, tables shared as
        the config shares them); `config` may add `generator` and
        `device`."""
        tables = [TableConfig.from_config(c) for c in config["tables"]]
        fcs = {
            f["name"]: FeatureConfig(
                name=f["name"], table=tables[f["table_index"]],
                input_shape=tuple(f["input_shape"]),
                output_shape=tuple(f["output_shape"]))
            for f in config["features"]
        }
        return cls(fcs, generator=config.get("generator"),
                   device=config.get("device"))


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
    keyed like its feature configs, computed with one `EmbedReduce` (f32)
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
        self._keys = list(layer._keys)
        self._feature_leaves = list(layer._feature_leaves)
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

    def forward(self, inputs: Any, weights: Any = None) -> dict:
        in_leaves = DistributedEmbedding._match_features(self, inputs)
        w_leaves = (
            DistributedEmbedding._match_features(self, weights,
                                                 allow_partial=True)
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
        return dict(zip(self._keys, outs))


def _table_rows_sources(layer: DistributedEmbedding) -> dict:
    """{table name: rows_of(lo, hi)}, rows [lo, hi) of each table of the
    layer (stacked or dense) in its storage dtype, read without a copy of
    the whole table."""
    out = {}
    for i, stack in enumerate(layer.stacks):
        state_table = layer.stack_state(i)["table"]
        for ts in stack.tables:
            out[ts.name] = (
                lambda lo, hi, stack=stack, n=ts.name, t=state_table:
                table_rows(stack, t, n, lo, hi)
            )
    for name, er in layer.dense_tables.items():
        out[name] = lambda lo, hi, e=er: e.embeddings.detach()[lo:hi]
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
