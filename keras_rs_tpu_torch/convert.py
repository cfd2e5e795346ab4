"""Loads parameters exported from the JAX package into the port's modules.

The caller hands over numpy arrays (this module never imports JAX):

  * `params`: one array per `model.named_parameters()` name, e.g.
    "bottom_mlp.layers.0.kernel", "dcn_layers.1.down_proj_kernel",
    "small_embeddings.cat_3.embeddings". Dense and FeatureCross kernels
    keep the JAX [in, out] layout on both sides (the port computes
    x @ kernel), so they copy without a transpose.
  * `tables`: logical [vocab, dim] embedding tables by table name, as
    `DistributedEmbedding.get_embedding_tables` exports them; they go in
    through `set_embedding_tables`. This works whatever the two stacks'
    layouts; optimizer slots keep their initial values (both packages
    start Adagrad-like accumulators at initial_accumulator_value and
    Adam/FTRL's other slots at 0).
  * `states`: whole stack states by stack name, as the JAX layer holds
    them (`layer.state.value`): {"table", "step"} and, for a split
    stack, "slots" {name: [R, dim] or [R]}. They are copied where the
    layouts match: the same shapes, which is every stack but the JAX
    package's bit-packed bf16 dim-128 stacks (those take `tables`). A
    state may name its layout, "layout": [(table name, local offset,
    rotation), ...] as the JAX stack's table specs hold them (its
    `table_stacking` and `shard_rotation`); a port stack laid out
    otherwise raises instead of taking rows into the wrong tables. The
    JAX arrays are global: a port layer sharded over D ranks takes its
    rank's block of D * R rows.

`load_params` also carries the TwoTower, BasicRanking and GRU4Rec
models, the GRU, full-rank and low-rank FeatureCross layers and Dense /
MLP stacks (with or without regularizers or a bias), whose parameter
names are the reference's attribute paths ("gru.recurrent_kernel",
"kernel", "layers.0.bias"); the GRU keeps the JAX [in, 3H] layout and
(z, r, h) gate order, so nothing is reordered. A k-means IVF index
(`KMeansRetrieval`) comes across through `load_kmeans_index`, and the
arrays of a frozen or int8 serving layer (`FrozenEmbedding`,
`QuantizedEmbedReduce`: embeddings, q, scale, qp) through
`load_serving_arrays`.

bf16 arrays arrive as ml_dtypes.bfloat16 numpy arrays, which
`torch.from_numpy` rejects; `as_tensor` reads them through a uint16 view.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def as_tensor(x: Any) -> torch.Tensor:
    """A tensor of `x` (a tensor is returned as it is); numpy bf16
    (ml_dtypes) becomes torch.bfloat16 bit for bit."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _copy(dst: torch.Tensor, value: Any, name: str) -> None:
    src = as_tensor(value)
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(
            f"{name}: expected {dst.dtype} {tuple(dst.shape)}, got "
            f"{src.dtype} {tuple(src.shape)} (layouts differ: pass the "
            "logical tables instead)."
        )
    dst.copy_(src)


@torch.no_grad()
def load_params(
    model: nn.Module,
    params: Mapping[str, np.ndarray],
    tables: Mapping[str, np.ndarray] | None = None,
    states: Mapping[str, Mapping[str, Any]] | None = None,
) -> None:
    """Copies `params` into every named parameter of `model` (all must be
    given, with matching shapes), `tables` into the model's
    DistributedEmbedding layers and `states` into their stacks. A value
    of None is an array the JAX module holds as None, such as the bias
    of a Dense built with use_bias=False: the port's module, built
    alike, has no such parameter, and one that has it raises as
    missing."""
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )

    params = {k: v for k, v in params.items() if v is not None}
    named = dict(model.named_parameters())
    missing = set(named) - set(params)
    unknown = set(params) - set(named)
    if missing or unknown:
        raise ValueError(
            f"Parameter names differ: missing {sorted(missing)}, unknown "
            f"{sorted(unknown)}."
        )
    for name, p in named.items():
        value = as_tensor(params[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: expected shape {tuple(p.shape)}, got "
                f"{tuple(value.shape)}."
            )
        p.copy_(value)
    layers = [
        m for m in model.modules() if isinstance(m, DistributedEmbedding)
    ]
    if tables:
        known = {
            t.name for layer in layers for s in layer.stacks for t in s.tables
        } | {name for layer in layers for name in layer.dense_tables}
        if set(tables) - known:
            raise ValueError(
                f"Unknown tables: {sorted(set(tables) - known)}."
            )
        for layer in layers:
            layer.set_embedding_tables(tables)
    if states:
        stacks = {
            s.name: (layer, i)
            for layer in layers
            for i, s in enumerate(layer.stacks)
        }
        if set(states) - set(stacks):
            raise ValueError(
                f"Unknown stacks: {sorted(set(states) - set(stacks))}."
            )
        for stack_name, value in states.items():
            layer, i = stacks[stack_name]
            state = layer.stack_state(i)
            stack = layer.stacks[i]
            want = [(t.name, t.local_offset, t.rotation)
                    for t in stack.tables]
            got = value.get("layout")
            if got is not None and [tuple(x) for x in got] != want:
                raise ValueError(
                    f"{stack_name}: the state is laid out as {list(got)}, "
                    f"the port's stack as {want} (another table_stacking "
                    "or shard_rotation): pass the logical tables instead."
                )
            value = _rank_block(value, stack.rows_per_shard,
                                stack.num_shards, layer.shard)
            if set(value.get("slots", {})) != set(state.get("slots", {})):
                raise ValueError(
                    f"{stack_name}: slots {sorted(value.get('slots', {}))} "
                    f"for a stack with {sorted(state.get('slots', {}))}."
                )
            _copy(state["table"], value["table"], f"{stack_name}.table")
            _copy(state["step"], value["step"], f"{stack_name}.step")
            for k, slot in state.get("slots", {}).items():
                _copy(slot, value["slots"][k], f"{stack_name}.slots.{k}")


def _rank_block(value: Mapping[str, Any], rows: int, D: int,
                rank: int) -> dict[str, Any]:
    """A stack state's arrays of D * rows rows cut to rank's block of
    `rows` (the JAX global array's rows on device `rank`); at D = 1, or
    for arrays of another length, the state as it is."""
    if D == 1:
        return dict(value)

    def cut(a: Any) -> Any:
        a = as_tensor(a)
        if a.ndim and a.shape[0] == D * rows:
            return a[rank * rows : (rank + 1) * rows]
        return a

    out = {k: v for k, v in value.items() if k not in ("table", "slots")}
    out["table"] = cut(value["table"])
    if "slots" in value:
        out["slots"] = {k: cut(v) for k, v in value["slots"].items()}
    return out


def load_kmeans_index(layer: Any, index: Mapping[str, Any]) -> None:
    """Installs a `KMeansRetrieval` index exported as numpy arrays
    (`centroids`, `cluster_candidates`, `cluster_ids`, `cluster_valid`,
    and for quantize="int8" `cluster_scales`, `cluster_pos`,
    `flat_candidates`) in the port's layer, on the layer's device; an
    array given as None is left out."""
    layer.set_index(**{k: as_tensor(v) for k, v in index.items()
                       if v is not None})


@torch.no_grad()
def load_serving_arrays(module: nn.Module, arrays: Mapping[str, Any]) -> None:
    """Copies the JAX package's serving arrays into the port's modules, bit
    for bit: for a `QuantizedEmbedReduce` or `EmbedReduce`, {field: array}
    with the fields its layout holds ("q", "scale", "qp"; "embeddings");
    for a `FrozenEmbedding`, {feature name: {field: array}} as the JAX
    FrozenEmbedding's per-feature reducers hold them (features that share
    a table share the port's module, and their arrays are equal)."""
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        FrozenEmbedding,
    )

    if isinstance(module, FrozenEmbedding):
        unknown = set(arrays) - set(module._reducers)
        if unknown:
            raise ValueError(f"Unknown features: {sorted(unknown)}.")
        for feature, fields in arrays.items():
            load_serving_arrays(module._reducers[feature], fields)
        return
    held = dict(module.named_parameters(recurse=False))
    held.update(module.named_buffers(recurse=False))
    for field, value in arrays.items():
        if field not in held:
            raise ValueError(
                f"{type(module).__name__} holds no tensor {field!r} (it "
                f"holds {sorted(held)})."
            )
        _copy(held[field], value, field)
