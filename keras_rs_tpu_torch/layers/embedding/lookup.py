"""Stacked embedding lookup with the fused optimizer update.

Counterpart of keras_rs_tpu/layers/embedding/lookup.py, for both state
layouts (init_stack_state), on one device and, one rank per device, on
D > 1 shards (lookup.py:128-260 forward, :322-523 backward): a rank
holds its shard of the stack, its B / D samples and what its
preprocessing received from every rank (device_preprocessing.py), and
the two [., dim] exchanges run over the mesh axis's process group
(parallel/collectives.py).

  forward  (`stack_gather`; construction order, lookup.py:275-302):
    gather each entry's table row (bf16 rows cast to f32), then per
    feature a dense [B, L, dim] * gain sum over L. Where the
    construction-order arrays are absent (a feature's ids narrower or
    wider than its declared valence, e.g. a densified Ragged batch, or a
    bucket capacity below the entry count) the sorted forward runs
    instead (lookup.py:213-249 at D = 1): gather the rows of the
    bucketed entries, scale them by their gains and segment-sum them
    into the B * F segments.
  backward (`stack_update`, lookup.py:330-523): gather the cotangent by
    each entry's segment and scale by its gain, segment-sum into the U
    unique rows, then update the live unique rows (the first n_valid of
    U, counted on the device):
      * packed state, Adagrad or SGD: one fused read-apply-write per row
        (ops/row_ops.py::apply_scatter_row_blocks, kernel B1);
      * packed state, other optimizers (Adam, FTRL): gather the [k, dim]
        blocks, `optimizer.apply`, write the blocks back
        (scatter_row_blocks_unique, kernel B2);
      * split state, bf16 table + row-wise Adagrad: one kernel gathers,
        applies, updates the accumulator in place and rounds the new
        rows stochastically (ops/row_ops.py::apply_split_rows), then B3
        scatters them;
      * split state, other: gather the rows and the slot rows,
        `optimizer.apply`, stochastic rounding for bf16 tables
        (round_split_rows), then one scatter of the table and every
        [R, dim] slot (scatter_rows_unique_multi: B3 for the table
        alone, B4 for the table with slots) and `index_copy_` for each
        row-wise [R] slot.

  at D > 1 the forward is the sorted one over all D * S_l global
  segments (partial sums of this shard's rows for every rank's
  samples), then `reduce_scatter` to this rank's [S_l, dim]; the
  backward starts with `all_gather` of the [S_l, dim] cotangents to
  [D * S_l, dim] and updates this rank's shard as above.
  `comm_dtype="bfloat16"` sends only those two exchanges in bf16: the
  partial sums are taken in f32 and cast before the reduce-scatter, the
  gathered cotangents cast back to f32 at once (lookup.py:141-150).

The update follows the Overwrite contract of the JAX package
(training/train_state.py:30-35): the backward pass writes the new table
and optimizer slots into the state in place and adds 1 to the stack's
step counter; autograd returns no gradient for the state. The two
halves are also plain functions, so a pipelined step
(training/pipelined.py) gathers without autograd and updates from a
cotangent it computed elsewhere.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from keras_rs_tpu_torch.layers.embedding.stacking import TableStack
from keras_rs_tpu_torch.parallel import collectives
from keras_rs_tpu_torch.ops.row_ops import (
    FUSED_OPTIMIZERS,
    SPLIT_FUSED_OPTIMIZERS,
    apply_scatter_row_blocks,
    apply_split_rows,
    round_split_rows,
    scatter_row_blocks_unique,
    scatter_rows_unique_multi,
)
from keras_rs_tpu_torch.utils import tracing

#: Philox key base of the stochastic rounding of bf16 rows; the kernel
#: adds the step count from the device and the shard sits at bit 24, so a
#: run repeats itself (the JAX package folds its step into
#: jax.random.key(0x5EED)).
ROUNDING_SEED = 0x5EED << 32


def init_stack_state(
    stack: TableStack, table: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Bundles a stacked [R, dim] table with its optimizer slots and step.

    Packed layout (`stack.packed_state`): {"table": [R, state_stride,
    dim], "step": []}: the table row and its slot rows form one
    contiguous block per logical row, so the backward's update reads and
    writes each unique row once.
    Split layout (every other stack): {"table": [R, dim] in the storage
    dtype, "slots": {name: [R, dim] f32, or [R] f32 for a row-wise
    slot}, "step": []}. Slots stay f32 for bf16 tables.
    """
    R, dim = table.shape
    opt = stack.optimizer
    step = torch.zeros((), dtype=torch.float32, device=table.device)
    if not stack.packed_state:
        slots = {
            name: opt.init_slot(
                name, (R,) if name in opt.rowwise_slots else (R, dim),
                torch.float32, table.device,
            )
            for name in opt.slot_names
        }
        return {
            "table": table.to(stack.storage_dtype),
            "slots": slots,
            "step": step,
        }
    packed = torch.empty(
        (R, stack.state_stride, dim), dtype=table.dtype, device=table.device
    )
    packed[:, 0] = table
    for i, name in enumerate(opt.slot_names):
        packed[:, 1 + i] = opt.init_slot(
            name, (R, dim), table.dtype, table.device
        )
    return {"table": packed, "step": step}


def _rows(stack: TableStack, table: torch.Tensor,
          slots: torch.Tensor) -> torch.Tensor:
    """[N, dim] table rows of `slots`, in the storage dtype."""
    return table[slots, 0] if stack.packed_state else table[slots]


def stack_gather(stack: TableStack, state: Mapping[str, torch.Tensor],
                 coo: Mapping[str, torch.Tensor], group=None,
                 comm_dtype: str | None = None) -> torch.Tensor:
    """The lookup's forward without autograd: activations [Bl * F, dim]
    (sample-major, Bl = B / D this rank's samples) of the stack's table
    for the batch of `coo`. It only reads the state; at D > 1 every rank
    of `group` must call it (one reduce-scatter)."""
    return _forward(stack, state["table"], coo, group, comm_dtype)


def _forward(stack: TableStack, table: torch.Tensor,
             coo: Mapping[str, torch.Tensor], group=None,
             comm_dtype: str | None = None) -> torch.Tensor:
    if "fwd_slots" not in coo:
        partial = _forward_sorted(stack, table, coo)
        if stack.num_shards == 1:
            return partial
        # Partial sums of every rank's segments -> each rank's own, summed
        # over the shards: a reduce-scatter.
        if comm_dtype == "bfloat16":
            partial = partial.to(torch.bfloat16)
        return collectives.reduce_scatter(partial, group).float()
    B = stack.batch_size
    dim = stack.stack_dim
    rows = _rows(stack, table, coo["fwd_slots"])
    gains = coo["fwd_gains"]
    parts: list = [None] * stack.num_features
    off = 0
    for f in stack.features:
        n = f.batch_size * f.valence
        parts[f.feature_index] = (
            rows[off : off + n].float().view(B, f.valence, dim)
            * gains[off : off + n].view(B, f.valence, 1)
        ).sum(dim=1)
        off += n
    return torch.stack(parts, dim=1).reshape(B * stack.num_features, dim)


def _forward_sorted(stack: TableStack, table: torch.Tensor,
                    coo: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The bucketed entries' rows times their (divisor-folded) gains,
    segment-summed into the B * F global sample-major segments (at D > 1
    this shard's partial sums). Padding entries read the zero sink row
    with gain 0."""
    contrib = (_rows(stack, table, coo["recv_slots"]).float()
               * coo["recv_gains"][:, None])
    return torch.zeros(
        (stack.batch_size * stack.num_features, stack.stack_dim),
        dtype=torch.float32, device=contrib.device,
    ).index_add_(0, coo["recv_segs"], contrib)


def stack_update(stack: TableStack, state: dict[str, torch.Tensor],
                 coo: Mapping[str, torch.Tensor],
                 d_acts: torch.Tensor, group=None,
                 comm_dtype: str | None = None) -> None:
    """The lookup's backward: applies the stack's optimizer to `state` in
    place from the activations' cotangent `d_acts` [Bl * F, dim] of the
    batch of `coo`, and adds 1 to the step counter. It needs only the COO
    arrays and the cotangent, not the forward's activations, so a
    pipelined step updates the tables without a second gather. At D > 1
    every rank of `group` must call it (one all-gather). Traced as the
    span "embedding.update"; counts "embedding.unique_rows"."""
    with tracing.span("embedding.update", stack=stack.name):
        _update(stack, state, coo, d_acts, group, comm_dtype)


def _update(stack: TableStack, state: dict[str, torch.Tensor],
            coo: Mapping[str, torch.Tensor], d_acts: torch.Tensor,
            group, comm_dtype: str | None) -> None:
    # U from the batch's arrays: a batch preprocessed before its stack's
    # capacities grew keeps its own shapes.
    U = coo["unique_slots"].shape[0]
    dim = stack.stack_dim
    g_all = d_acts
    if stack.num_shards > 1:
        # Every rank's cotangents: the entries this shard received belong
        # to any rank's samples.
        g_all = collectives.all_gather(
            d_acts.to(torch.bfloat16 if comm_dtype == "bfloat16"
                      else torch.float32), group)
    # Per-entry gradient: the cotangent of the entry's segment times its
    # (divisor-folded) gain.
    ge = g_all.float()[coo["recv_segs"]] * coo["recv_gains"][:, None]
    del g_all
    # Segment-sum into the unique rows. Padding and unique-capacity
    # overflow entries carry the sentinel U; index_add_ faults on an
    # out-of-range index where jax's segment_sum drops it, so sum into
    # U + 1 rows and drop the last.
    row_grads = torch.zeros(
        (U + 1, dim), dtype=torch.float32, device=d_acts.device
    ).index_add_(0, coo["entry_unique"], ge)[:U]
    del ge
    u_slots = coo["unique_slots"]
    # Uniques are a prefix of u_slots, sink-padded at the top: only the
    # first n_valid rows update (counted on the device, no host sync).
    # The tail rows carry exactly-zero gradients, so the functions that
    # write them (the plain versions, index_copy_) write their own bytes.
    n_valid = (u_slots != stack.sink_slot).sum(dtype=torch.int32).reshape(1)
    tracing.count("embedding.unique_rows", n_valid)
    optimizer = stack.optimizer
    table = state["table"]
    step = state["step"]
    if stack.packed_state and optimizer.name in FUSED_OPTIMIZERS:
        apply_scatter_row_blocks(
            table, u_slots, row_grads, step.reshape(1), optimizer, n_valid
        )
    elif stack.packed_state:
        blk = table[u_slots.long()]  # [U, stride, dim]
        names = optimizer.slot_names
        new_rows, new_slots = optimizer.apply(
            blk[:, 0], row_grads,
            {name: blk[:, 1 + i] for i, name in enumerate(names)}, step,
        )
        del blk
        new_blk = torch.stack(
            [new_rows] + [new_slots[name] for name in names], dim=1
        )
        del new_rows, new_slots
        scatter_row_blocks_unique(table, u_slots, new_blk, n_valid)
    else:
        _split_update(stack, state, u_slots, row_grads, n_valid,
                      collectives.rank(group))
    step.add_(1.0)


def _split_update(stack: TableStack, state: dict[str, torch.Tensor],
                  u_slots: torch.Tensor, row_grads: torch.Tensor,
                  n_valid: torch.Tensor, shard: int = 0) -> None:
    """The split layout's update (JAX lookup.py:448-523, without the
    bit-packed branches). A bf16 table rounds its new rows stochastically
    with bits drawn on the device from the step and the shard (as the
    JAX package folds in both), so no host read: with row-wise Adagrad
    the whole update but the scatter is one kernel (apply_split_rows,
    counted as "embedding.split_fused_rows"); other optimizers apply in
    PyTorch and round with round_split_rows."""
    optimizer = stack.optimizer
    table, slots, step = state["table"], state["slots"], state["step"]
    bf16 = table.dtype == torch.bfloat16
    seed = ROUNDING_SEED + (shard << 24)
    if bf16 and optimizer.name in SPLIT_FUSED_OPTIMIZERS:
        tracing.count("embedding.split_fused_rows", n_valid)
        new_rows = apply_split_rows(
            table, slots["accumulator"], u_slots, row_grads,
            step.reshape(1), optimizer, n_valid, seed)
        scatter_rows_unique_multi([table], u_slots, [new_rows], n_valid)
        return
    u64 = u_slots.long()
    rows = table[u64].float()
    slot_rows = {k: v[u64] for k, v in slots.items()}
    new_rows, new_slot_rows = optimizer.apply(
        rows, row_grads, slot_rows, step
    )
    del rows, slot_rows
    if bf16:
        new_rows = round_split_rows(new_rows, u_slots, step.reshape(1),
                                    n_valid, seed)
    row_keys = [k for k in slots if slots[k].ndim == 2]
    scatter_rows_unique_multi(
        [table] + [slots[k] for k in row_keys],
        u_slots,
        [new_rows] + [new_slot_rows[k] for k in row_keys],
        n_valid,
    )
    # Row-wise [R] slots: U * 4 bytes through index_copy_ (the JAX package
    # uses XLA's 1-D scatter). The sink duplicates write identical values.
    for k in slots:
        if slots[k].ndim == 1:
            slots[k].index_copy_(0, u64, new_slot_rows[k])


class _StackLookup(torch.autograd.Function):
    """Lookup whose backward updates the stack state in place.

    `anchor` is a 0-dim tensor that requires grad: autograd calls
    `backward` only when some input requires grad, and the state itself
    must stay out of autograd (no saved tensors, so the in-place update
    cannot trip a version counter, and no dense optimizer sees it).
    """

    @staticmethod
    def forward(ctx, anchor, stack, state, coo, group, comm_dtype):
        ctx.stack, ctx.state, ctx.coo = stack, state, coo
        ctx.group, ctx.comm_dtype = group, comm_dtype
        return stack_gather(stack, state, coo, group, comm_dtype)

    @staticmethod
    def backward(ctx, d_acts):
        stack_update(ctx.stack, ctx.state, ctx.coo, d_acts, ctx.group,
                     ctx.comm_dtype)
        return None, None, None, None, None, None


def stack_lookup(
    stack: TableStack,
    state: dict[str, torch.Tensor],
    coo: Mapping[str, torch.Tensor],
    group=None,
    comm_dtype: str | None = None,
) -> torch.Tensor:
    """Differentiable lookup for one stack (on one rank at D > 1, with
    the process group of the mesh axis the stack is sharded over).

    `coo` holds the device arrays of `DistributedEmbedding.preprocess`:
    fwd_slots (int64) and fwd_gains for the construction-order forward,
    or recv_slots (int64) for the sorted one, and recv_segs (int64),
    recv_gains, entry_unique (int64) and unique_slots (int32), all
    flattened.
    Returns activations [Bl * F, dim] (sample-major, Bl = B / D). When
    grad mode is on, the backward pass applies the stack's optimizer to
    `state` in place; when it is off, this is `stack_gather`. Traced as
    the span "embedding.lookup" (utils/tracing.py).
    """
    with tracing.span("embedding.lookup", stack=stack.name):
        if not torch.is_grad_enabled():
            return stack_gather(stack, state, coo, group, comm_dtype)
        anchor = torch.zeros((), device=state["table"].device,
                             requires_grad=True)
        return _StackLookup.apply(anchor, stack, state, coo, group,
                                  comm_dtype)


def split_activations(
    stack: TableStack, acts: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Lookup activations -> per-feature [Bl, dim_f] tensors (a reshape
    and a static slice: segments are sample-major)."""
    a = acts.reshape(stack.local_batch_size, stack.num_features,
                     stack.stack_dim)
    return {
        f.name: a[:, f.feature_index, : f.embedding_dim]
        for f in stack.features
    }


def merge_cotangents(
    stack: TableStack, d_by_name: Mapping[str, Any], device: torch.device
) -> torch.Tensor:
    """The inverse of `split_activations` for cotangents: per-feature
    [Bl, dim_f] tensors (None counts as zero) -> the stack's
    [Bl * F, stack_dim] f32 layout, zero past each feature's width."""
    Bl = stack.local_batch_size
    d = torch.zeros((Bl, stack.num_features, stack.stack_dim),
                    dtype=torch.float32, device=device)
    for f in stack.features:
        g = d_by_name[f.name]
        if g is not None:
            d[:, f.feature_index, : f.embedding_dim] = g.reshape(
                Bl, f.embedding_dim)
    return d.reshape(-1, stack.stack_dim)


def combine_cotangents(stack: TableStack,
                       d_feats: Mapping[str, Any]) -> torch.Tensor:
    """The JAX package's name for `merge_cotangents` (the inverse of
    `split_activations`, for hand-written backward paths), on the device
    of the given cotangents."""
    given = [g for g in d_feats.values() if g is not None]
    if not given:
        raise ValueError("combine_cotangents needs at least one cotangent "
                         "tensor to take its device from.")
    return merge_cotangents(stack, d_feats, given[0].device)
