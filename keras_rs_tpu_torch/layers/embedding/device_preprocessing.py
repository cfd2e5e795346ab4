"""COO preprocessing on the device (torch ops, no host round trip).

Counterpart of keras_rs_tpu/layers/embedding/device_preprocessing.py:
the same transform as preprocessing.preprocess_stack, computed from id
tensors that are already on the device, so that a training step can take
raw ids:

  raw ids [B, L] (device) -> CooBatch arrays (device) -> stacked lookup

It computes the same arrays as the numpy and C++ backends, bit for bit:
the same bucket layout, the same stable entry order (bucket-major, slot
ascending, then original order), the same dedup and sink contracts, the
same drops when a capacity overflows. All-sum stacks (every DLRM stack)
never divide, so their gains are exact too; the combiner divisors of mean
and sqrtn stacks are sums taken with `index_add_`, whose float atomics on
CUDA may add in another order than numpy (a few ulp).

Every shape is static (set by the stack's capacities, not by the data),
and no step reads a value back to the host: there is no `bincount`,
`unique`, `nonzero`, boolean-mask indexing or `.item()` here, each of
which waits for the device. Bucket counts come from `searchsorted` on the
sorted keys, dedup from adjacency and `cumsum` over the sorted slots, and
scatters go through buffers with one spare element that takes the
dropped entries. The observed stats come back as 0-d device tensors
(`DeviceStats`); a caller that wants them on the host reads them when it
chooses to.

At D > 1 a rank transforms its own slice of the batch and exchanges
its buckets with the other ranks (`shard=`, one all_to_all): the JAX
package runs the same transform on the global arrays inside jit, where
XLA inserts the exchange.

Library torch ops only: the reference runs no Pallas kernel here.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from keras_rs_tpu_torch.layers.embedding.preprocessing import CooBatch
from keras_rs_tpu_torch.layers.embedding.stacking import TableStack
from keras_rs_tpu_torch.parallel import collectives

_INT_MAX = 2**31 - 1  # dedup key of an empty position (slots are int32)


class DeviceStats(NamedTuple):
    """Observed input stats as 0-d int32 device tensors (the fields of
    preprocessing.InputStats)."""

    max_ids_per_bucket: torch.Tensor
    max_unique_per_shard: torch.Tensor
    dropped_ids: torch.Tensor


def _as_matrix(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def preprocess_stack_device(
    stack: TableStack,
    inputs: Mapping[str, torch.Tensor],
    weights: Mapping[str, torch.Tensor] | None = None,
    *,
    shard: int | None = None,
    group=None,
) -> tuple[CooBatch, DeviceStats]:
    """preprocessing.preprocess_stack on the device.

    `inputs[feature_name]`: int tensor [B] or [B, L] on the device; ids
    outside [0, vocab) or with a zero weight are ignored.
    `weights[feature_name]`, where given: float tensor of the ids' shape.
    Returns the CooBatch (device tensors of the numpy path's shapes and
    dtypes; fwd_slots / fwd_gains under the numpy path's gate) and the
    stats.

    With `shard` (a rank of a D-shard layer, D > 1) the inputs are that
    rank's B / D samples and the result is its part of the global
    transform: send_* [1, D, C] are row `shard` of the global arrays,
    the all_to_all over `group` (one collective of the three arrays)
    gives recv_* [D, C], which are column `shard` (bucket (d, shard) of
    every source d), and unique_slots [1, U] / entry_unique [1, D * C]
    dedup what this rank received, as the JAX package does for device
    `shard`: the integers equal the global transform's bit for bit. The
    stats are this rank's (its buckets, its uniques; parallel/multihost
    merges them across ranks).
    """
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    B = stack.batch_size
    Bl = B // D
    F = stack.num_features
    S_l = F * Bl
    R_l = stack.rows_per_shard
    sink = stack.sink_slot
    device = inputs[stack.features[0].name].device
    all_sum = all(t.combiner == "sum" for t in stack.tables)
    # Sources in the input: every device (global) or this rank alone.
    rank_mode = shard is not None and D > 1
    n_src = 1 if rank_mode else D
    n_in = n_src * Bl
    sample = torch.arange(n_in, device=device)

    # --- the flattened entry list, feature by feature -----------------
    ds, ss, slots, segs, gains, valids = [], [], [], [], [], []
    for fspec in stack.features:
        ids = _as_matrix(inputs[fspec.name])
        if ids.shape[0] != n_in:
            raise ValueError(
                f"Feature {fspec.name}: expected "
                f"{'local' if rank_mode else 'global'} batch {n_in}, got "
                f"{ids.shape[0]}."
            )
        L = ids.shape[1]
        tspec = stack.table_spec(fspec.table_name)
        r = ids.reshape(-1).long()
        valid = (r >= 0) & (r < tspec.vocabulary_size)
        w = None if weights is None else weights.get(fspec.name)
        if w is None:
            g = valid.float()
        else:
            w = _as_matrix(w.float())
            if w.shape != ids.shape:
                raise ValueError(
                    f"Feature {fspec.name}: weights shape "
                    f"{tuple(w.shape)} != ids shape {tuple(ids.shape)}."
                )
            g = w.reshape(-1)
            valid &= g != 0
            # where, not g * valid: an inf or nan weight at an invalid
            # id must become exactly 0.
            g = torch.where(valid, g, 0.0)
        r = torch.where(valid, r, 0)

        def per_entry(per_sample: torch.Tensor) -> torch.Tensor:
            return per_sample[:, None].expand(n_in, L).reshape(-1)

        ds.append(per_entry(sample // Bl))
        ss.append((r + tspec.rotation) % D)
        slots.append(tspec.local_offset + r // D)
        # Sample-major segment ids: activations reshape to [B, F, dim].
        segs.append(per_entry((sample % Bl) * F + fspec.feature_index))
        gains.append(g)
        valids.append(valid)
    d, s, slot, seg, gain, valid = (
        torch.cat(x) for x in (ds, ss, slots, segs, gains, valids)
    )
    N = d.shape[0]
    n_buckets = n_src * D

    # --- combiner divisors [n_src, S_l] -------------------------------
    if all_sum:
        divisors = torch.ones((n_src, S_l), dtype=torch.float32,
                              device=device)
    else:
        div_idx = torch.where(valid, d * S_l + seg, n_src * S_l)
        sums = torch.zeros((2, n_src * S_l + 1), dtype=torch.float32,
                           device=device)
        sums[0].index_add_(0, div_idx, gain)
        sums[1].index_add_(0, div_idx, gain * gain)
        sum_g, sum_g2 = sums[:, : n_src * S_l].reshape(2, n_src, Bl, F)
        divisors = torch.ones((n_src, Bl, F), dtype=torch.float32,
                              device=device)
        for fspec in stack.features:
            combiner = stack.table_spec(fspec.table_name).combiner
            f = fspec.feature_index
            if combiner == "mean":
                divisors[:, :, f] = sum_g[:, :, f]
            elif combiner == "sqrtn":
                divisors[:, :, f] = torch.sqrt(sum_g2[:, :, f])
        divisors = torch.where(divisors == 0, 1.0, divisors).view(n_src,
                                                                  S_l)

    # --- bucket by (source device, shard); slot-ascending within ------
    # One stable sort on the fused int64 key bucket * R_l + slot: the
    # numpy path's lexsort((slot, s, d)), ties in the original order.
    bucket = torch.where(valid, d * D + s, n_buckets)
    key_s, order = torch.sort(bucket * R_l + slot, stable=True)
    seg_s = seg[order]
    gain_s = gain[order]
    bucket_s = key_s // R_l
    slot_s = key_s - bucket_s * R_l
    # Bucket starts from the sorted keys (bincount would read the max).
    starts = torch.searchsorted(
        bucket_s, torch.arange(n_buckets + 1, device=device)
    )
    counts = starts[1:] - starts[:-1]  # [n_buckets]; invalid: n_buckets

    if D == 1:
        # One bucket, whose entries the sort put first: the bucket fill
        # is a slice and a mask.
        m = min(N, C)
        ok = bucket_s[:m] == 0

        def fill(x_s: torch.Tensor, pad, dtype) -> torch.Tensor:
            out = torch.full((C,), pad, dtype=dtype, device=device)
            out[:m] = torch.where(ok, x_s[:m], pad)
            return out.view(1, 1, C)

        send_slots = fill(slot_s, sink, torch.int32)
        send_segs = fill(seg_s, 0, torch.int32)
        send_gains = fill(gain_s, 0.0, torch.float32)
    else:
        rank = torch.arange(N, device=device) - starts[
            bucket_s.clamp(max=n_buckets - 1)
        ]
        within = (bucket_s < n_buckets) & (rank < C)
        # Dropped entries land on the spare last element.
        flat_idx = torch.where(within, bucket_s * C + rank, n_buckets * C)

        def scatter(x_s: torch.Tensor, pad, dtype) -> torch.Tensor:
            out = torch.full((n_buckets * C + 1,), pad, dtype=dtype,
                             device=device)
            out.scatter_(0, flat_idx, x_s.to(dtype))
            return out[: n_buckets * C].view(n_src, D, C)

        send_slots = scatter(slot_s, sink, torch.int32)
        send_segs = scatter(seg_s, 0, torch.int32)
        send_gains = scatter(gain_s, 0.0, torch.float32)

    # Fold the divisor into the gains (the numpy path's expression, so
    # equal inputs give equal bits); all-sum stacks skip it (x / 1.0).
    src = torch.arange(n_src, device=device)[:, None, None]
    if not all_sum:
        send_gains = send_gains / divisors[src, send_segs.long()]
    # Globalized segment ids: source device * S_l + segment.
    first_src = shard if rank_mode else 0
    send_segs = send_segs + ((src + first_src) * S_l).int()

    max_ids = counts.max()
    dropped = (counts - C).clamp(min=0).sum()

    # --- per-shard dedup of the received slots (backward pass) --------
    recv = None
    if D == 1:
        # The bucket is slot-sorted already: adjacency dedup, and the
        # entry order is the sorted order.
        key_u = torch.where(ok, slot_s[:m], _INT_MAX)
        prev = torch.cat([key_u.new_full((1,), -1), key_u[:-1]])
        new_unique = ok & (key_u != prev)
        uidx = torch.cumsum(new_unique, 0) - 1
        max_unique = new_unique.sum()
        # unique_slots[u] = the u-th distinct slot, ascending, sink
        # padded; uniques past U - 1 overflow to the sink.
        keep = ok & (uidx < U - 1)
        unique_slots = torch.full((U + 1,), sink, dtype=torch.int32,
                                  device=device)
        unique_slots.scatter_(0, torch.where(new_unique & keep, uidx, U),
                              key_u.int())
        unique_slots = unique_slots[:U].view(1, U)
        # U (one past the end) drops an entry's update: padding and
        # unique-capacity overflow.
        entry_unique = torch.full((C,), U, dtype=torch.int32,
                                  device=device)
        entry_unique[:m] = torch.where(keep, uidx, U)
        entry_unique = entry_unique.view(1, C)
    else:
        if rank_mode:
            # The exchange: bucket e of this rank goes to rank e, and
            # block d of what comes back is bucket (d, shard).
            packed = torch.stack(
                [send_slots[0], send_segs[0], send_gains[0].view(torch.int32)],
                dim=1)  # [D, 3, C]
            got = collectives.all_to_all(packed, group)
            recv = (got[:, 0], got[:, 1], got[:, 2].view(torch.float32))
            recv_slots = recv[0].reshape(1, D * C)
        else:
            # Shard e receives bucket (d, e) of every source d.
            recv_slots = send_slots.permute(1, 0, 2).reshape(D, D * C)
        unique_slots, entry_unique, max_unique = _dedup_received(
            recv_slots, U, sink, device)
    dropped_total = dropped + (max_unique - (U - 1)).clamp(min=0)

    coo = CooBatch(
        send_slots=send_slots,
        send_segs=send_segs,
        send_gains=send_gains,
        unique_slots=unique_slots,
        entry_unique=entry_unique,
        divisors=divisors,
    )
    if recv is not None:
        coo.recv_slots, coo.recv_segs, coo.recv_gains = recv
    # Construction-order forward arrays: the pre-sort entry list, masked,
    # under the numpy path's gate (construction_fwd and every feature at
    # its declared (batch, valence)).
    if stack.construction_fwd and all(
        tuple(_as_matrix(inputs[f.name]).shape) == (f.batch_size, f.valence)
        for f in stack.features
    ):
        fwd_gains = gain
        if not all_sum:
            fwd_gains = fwd_gains / divisors[d, seg]
        coo.fwd_slots = torch.where(valid, slot, sink).int().view(1, N)
        coo.fwd_gains = fwd_gains.view(1, N)
    stats = DeviceStats(
        max_ids_per_bucket=max_ids.int(),
        max_unique_per_shard=max_unique.int(),
        dropped_ids=dropped_total.int(),
    )
    return coo, stats


def _dedup_received(recv_slots: torch.Tensor, U: int, sink: int,
                    device) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Per-shard dedup of received slots [E, D * C] (E shards, each a
    concatenation of D slot-sorted runs, merged by one stable sort per
    shard): (unique_slots [E, U], entry_unique [E, D * C], the largest
    unique count)."""
    E, n = recv_slots.shape
    # Membership is occupancy (slot != sink), as in numpy and C++.
    key = torch.where(recv_slots != sink, recv_slots, _INT_MAX).long()
    key_s, pos_s = torch.sort(key, dim=1, stable=True)
    real_s = key_s != _INT_MAX
    prev = torch.nn.functional.pad(key_s[:, :-1], (1, 0), value=-1)
    new_unique = real_s & (key_s != prev)
    uidx = torch.cumsum(new_unique, 1) - 1
    max_unique = new_unique.sum(1).max()
    row = torch.arange(E, device=device)[:, None]
    # Dropped entries go to the spare element E * U: a per-row sentinel
    # would land in the next shard's first unique.
    u_flat = torch.where(new_unique & (uidx < U - 1), row * U + uidx, E * U)
    unique_slots = torch.full((E * U + 1,), sink, dtype=torch.int32,
                              device=device)
    unique_slots.scatter_(0, u_flat.reshape(-1), key_s.reshape(-1).int())
    unique_slots = unique_slots[: E * U].view(E, U)
    inv = torch.where(uidx < U - 1, uidx, U)
    e_write = torch.where(real_s, row * n + pos_s, E * n)
    entry_unique = torch.full((E * n + 1,), U, dtype=torch.int32,
                              device=device)
    entry_unique.scatter_(0, e_write.reshape(-1), inv.reshape(-1).int())
    return unique_slots, entry_unique[: E * n].view(E, n), max_unique
