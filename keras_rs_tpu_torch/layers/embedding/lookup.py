"""Stacked embedding lookup with the fused optimizer update (D = 1).

Counterpart of keras_rs_tpu/layers/embedding/lookup.py at one device, for
the packed [R, stride, dim] state.

  forward  (construction order, lookup.py:275-302): gather each entry's
    table row, then per feature a dense [B, L, dim] * gain sum over L.
  backward (lookup.py:330-423): gather the cotangent by each entry's
    segment and scale by its gain, segment-sum into the U unique rows,
    then one fused read-apply-write per live unique row
    (ops/row_ops.py::apply_scatter_row_blocks, the CUDA kernel on a card).

The update follows the Overwrite contract of the JAX package
(training/train_state.py:30-35): the backward pass writes the new table
and optimizer slots into the state in place and adds 1 to the stack's
step counter; autograd returns no gradient for the state.
"""

from __future__ import annotations

from typing import Mapping

import torch

from keras_rs_tpu_torch.layers.embedding.stacking import TableStack
from keras_rs_tpu_torch.ops.row_ops import apply_scatter_row_blocks


def init_stack_state(
    stack: TableStack, table: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Packs a stacked [R, dim] table with its optimizer slots.

    Returns {"table": [R, state_stride, dim], "step": []}: the table row
    and its slot rows form one contiguous block per logical row, so the
    backward's update reads and writes each unique row once.
    """
    if not stack.packed_state:
        raise NotImplementedError(
            f"Stack {stack.name!r} does not take the packed layout "
            "(f32, Adagrad-like, dim % 128 == 0); the split layout is not "
            "ported yet."
        )
    R, dim = table.shape
    opt = stack.optimizer
    packed = torch.empty(
        (R, stack.state_stride, dim), dtype=table.dtype, device=table.device
    )
    packed[:, 0] = table
    for i, name in enumerate(opt.slot_names):
        packed[:, 1 + i] = opt.init_slot(
            name, (R, dim), table.dtype, table.device
        )
    return {
        "table": packed,
        "step": torch.zeros((), dtype=torch.float32, device=table.device),
    }


def _forward(stack: TableStack, packed: torch.Tensor,
             coo: Mapping[str, torch.Tensor]) -> torch.Tensor:
    B = stack.batch_size
    dim = stack.stack_dim
    rows = packed[coo["fwd_slots"], 0]  # [N, dim]
    gains = coo["fwd_gains"]
    parts: list = [None] * stack.num_features
    off = 0
    for f in stack.features:
        n = f.batch_size * f.valence
        parts[f.feature_index] = (
            rows[off : off + n].view(B, f.valence, dim)
            * gains[off : off + n].view(B, f.valence, 1)
        ).sum(dim=1)
        off += n
    return torch.stack(parts, dim=1).reshape(B * stack.num_features, dim)


def _backward_update(stack: TableStack, state: dict[str, torch.Tensor],
                     coo: Mapping[str, torch.Tensor],
                     d_acts: torch.Tensor) -> None:
    U = stack.max_unique_ids_per_shard
    dim = stack.stack_dim
    # Per-entry gradient: the cotangent of the entry's segment times its
    # (divisor-folded) gain.
    ge = d_acts.float()[coo["recv_segs"]] * coo["recv_gains"][:, None]
    # Segment-sum into the unique rows. Padding and unique-capacity
    # overflow entries carry the sentinel U; index_add_ faults on an
    # out-of-range index where jax's segment_sum drops it, so sum into
    # U + 1 rows and drop the last.
    row_grads = torch.zeros(
        (U + 1, dim), dtype=torch.float32, device=d_acts.device
    ).index_add_(0, coo["entry_unique"], ge)[:U]
    u_slots = coo["unique_slots"]
    # Uniques are a prefix of u_slots, sink-padded at the top: only the
    # first n_valid rows update (counted on the device, no host sync).
    n_valid = (u_slots != stack.sink_slot).sum(dtype=torch.int32)
    apply_scatter_row_blocks(
        state["table"],
        u_slots,
        row_grads,
        state["step"].reshape(1),
        stack.optimizer,
        n_valid.reshape(1),
    )
    state["step"].add_(1.0)


class _StackLookup(torch.autograd.Function):
    """Lookup whose backward updates the stack state in place.

    `anchor` is a 0-dim tensor that requires grad: autograd calls
    `backward` only when some input requires grad, and the state itself
    must stay out of autograd (no saved tensors, so the in-place update
    cannot trip a version counter, and no dense optimizer sees it).
    """

    @staticmethod
    def forward(ctx, anchor, stack, state, coo):
        ctx.stack, ctx.state, ctx.coo = stack, state, coo
        return _forward(stack, state["table"], coo)

    @staticmethod
    def backward(ctx, d_acts):
        _backward_update(ctx.stack, ctx.state, ctx.coo, d_acts)
        return None, None, None, None


def stack_lookup(
    stack: TableStack,
    state: dict[str, torch.Tensor],
    coo: Mapping[str, torch.Tensor],
) -> torch.Tensor:
    """Differentiable lookup for one stack at D = 1.

    `coo` holds the device arrays of `DistributedEmbedding.preprocess`:
    fwd_slots (int64), fwd_gains, recv_segs (int64), recv_gains,
    entry_unique (int64) and unique_slots (int32), all flattened.
    Returns activations [B * F, dim] (sample-major). When grad mode is on,
    the backward pass applies the stack's optimizer to `state` in place.
    """
    if not stack.construction_fwd:
        raise NotImplementedError(
            f"Stack {stack.name!r}: the port runs the construction-order "
            "forward only (one shard and max_ids_per_partition >= "
            f"{stack.construction_entries})."
        )
    anchor = torch.zeros(
        (), device=state["table"].device,
        requires_grad=torch.is_grad_enabled(),
    )
    return _StackLookup.apply(anchor, stack, state, coo)


def split_activations(
    stack: TableStack, acts: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Lookup activations -> per-feature [B, dim_f] tensors (a reshape
    and a static slice: segments are sample-major)."""
    a = acts.reshape(stack.batch_size, stack.num_features, stack.stack_dim)
    return {
        f.name: a[:, f.feature_index, : f.embedding_dim]
        for f in stack.features
    }
