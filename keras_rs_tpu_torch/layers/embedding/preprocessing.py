"""Host-side COO preprocessing for the stacked embedding lookup (numpy).

Counterpart of keras_rs_tpu/layers/embedding/preprocessing.py: the same
vectorized numpy reference implementation, bit-identical output, but
importing this package's jax-free stacking. `preprocess_stack` runs it or
the C++ engine (native.py, the JAX package's native/coo_preprocess.cc);
device_preprocessing.py computes the same arrays on the device.

Layout for a stack with D shards, bucket capacity C, unique capacity U,
F features and local batch Bl (S_l = F * Bl local segments):

  send_slots  [D, D, C] i32   entry local row slot, bucketed (src, dst)
  send_segs   [D, D, C] i32   entry global segment id, SAMPLE-major
                              (src * S_l + local_sample * F + feature)
  send_gains  [D, D, C] f32   entry weight pre-divided by its segment's
                              combiner divisor (0 marks padding)
  unique_slots[D, U]    i32   per-shard deduped slots (padded with sink)
  entry_unique[D, D*C]  i32   received entry -> unique index; U (one past
                              the end) drops the entry's update
  divisors    [D, S_l]  f32   per-segment combiner divisor
  fwd_slots   [1, N]    i32   construction-order slots (D == 1 only)
  fwd_gains   [1, N]    f32   construction-order divisor-folded gains
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Sequence

import numpy as np

from keras_rs_tpu_torch.layers.embedding.stacking import TableStack


@dataclasses.dataclass
class CooBatch:
    """Preprocessed inputs for one stack: host numpy arrays, or device
    tensors of the same shapes and dtypes (preprocess_stack_device)."""

    send_slots: np.ndarray
    send_segs: np.ndarray
    send_gains: np.ndarray
    unique_slots: np.ndarray
    entry_unique: np.ndarray
    divisors: np.ndarray
    fwd_slots: np.ndarray | None = None  # [1, N] int32, sink = invalid
    fwd_gains: np.ndarray | None = None  # [1, N] f32, divisor-folded
    #: A rank's received buckets at D > 1 ([D, C] each: bucket (d, r) of
    #: every source d; device_preprocessing.preprocess_stack_device with
    #: `shard`).
    recv_slots: np.ndarray | None = None
    recv_segs: np.ndarray | None = None
    recv_gains: np.ndarray | None = None

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if v is not None
        }


@dataclasses.dataclass(frozen=True)
class InputStats:
    """Observed stats for capacity validation."""

    max_ids_per_bucket: int
    max_unique_per_shard: int
    dropped_ids: int


def construction_fwd_arrays(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None,
    divisors: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | tuple[None, None]:
    """(fwd_slots [1, N] i32, fwd_gains [1, N] f32) in construction
    order, or (None, None) when the path does not apply (not
    `stack.construction_fwd`, or a feature's runtime shape differs from
    its declared (batch, valence))."""
    if not stack.construction_fwd:
        return None, None
    F = stack.num_features
    sink = stack.sink_slot
    all_sum = all(t.combiner == "sum" for t in stack.tables)
    N = stack.construction_entries
    fwd_slots = np.empty(N, np.int32)
    fwd_gains = np.empty(N, np.float32)
    off = 0
    for fspec in stack.features:
        ids = np.asarray(inputs[fspec.name])
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape != (fspec.batch_size, fspec.valence):
            return None, None
        w = None if weights is None else weights.get(fspec.name)
        tspec = stack.table_spec(fspec.table_name)
        n = fspec.batch_size * fspec.valence
        r = ids.reshape(-1)
        sl = fwd_slots[off : off + n]
        gn = fwd_gains[off : off + n]
        if w is None:
            valid = (r >= 0) & (r < tspec.vocabulary_size)
            gn[:] = valid
        else:
            w = np.asarray(w, np.float32)
            if w.ndim == 1:
                w = w[:, None]
            g = w.reshape(-1)
            valid = (g != 0) & (r >= 0) & (r < tspec.vocabulary_size)
            # where, not g*valid: an inf/nan weight at an invalid id
            # must mask to exactly 0.0.
            gn[:] = np.where(valid, g, np.float32(0.0))
        # slot = local_offset + r at D == 1.
        np.add(
            np.where(valid, r, np.int64(sink - tspec.local_offset)),
            tspec.local_offset,
            out=sl,
            casting="unsafe",
        )
        if not all_sum:
            seg = (
                np.repeat(
                    np.arange(fspec.batch_size, dtype=np.int64),
                    fspec.valence,
                )
                * F
                + fspec.feature_index
            )
            np.divide(gn, divisors[0, seg], out=gn)
        off += n
    return fwd_slots[None], fwd_gains[None]


def preprocess_stack(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None = None,
    *,
    allow_drop: bool = True,
    backend: str = "auto",
) -> tuple[CooBatch, InputStats]:
    """Builds the CooBatch for one stack from per-feature id matrices.

    `inputs[feature_name]`: int array (B,) or (B, L); ids outside
    [0, vocab) are ignored. `weights[feature_name]`: float array of the
    same shape; zeros mark padding. Ids over capacity are dropped with a
    warning; with `allow_drop=False` they raise ValueError with the
    warning's text instead, on either backend.

    `backend`: "numpy" runs the implementation below, "native" the C++
    engine (raises if it cannot be built), "auto" the C++ engine where
    it builds and numpy otherwise, as in the JAX package. The backends
    agree bit for bit.
    """
    coo, stats = build_coo(stack, inputs, weights, backend=backend)
    if stats.dropped_ids:
        U = stack.max_unique_ids_per_shard
        unique_overflow = max(0, stats.max_unique_per_shard - (U - 1))
        msg = (
            f"Stack {stack.name!r}: "
            f"{stats.dropped_ids - unique_overflow} ids over bucket "
            f"capacity {stack.max_ids_per_partition} (max observed "
            f"{stats.max_ids_per_bucket}; raise max_ids_per_partition) and "
            f"{unique_overflow} unique rows over capacity {U - 1} (max "
            f"observed {stats.max_unique_per_shard}; raise "
            "max_unique_ids_per_partition)."
        )
        if not allow_drop:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=2)
    return coo, stats


def build_coo(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None = None,
    *,
    backend: str = "auto",
) -> tuple[CooBatch, InputStats]:
    """`preprocess_stack` without its check of dropped ids: the CooBatch
    (construction-order arrays included) and the stats, whatever was
    dropped. A caller that grows the capacities from the stats and
    builds again (the layer's training pass) takes this one."""
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"Unknown backend {backend!r}.")
    from keras_rs_tpu_torch.layers.embedding import native

    if backend == "native" or (backend == "auto" and native.available()):
        coo, stats = native.preprocess_stack_native(stack, inputs, weights)
    else:
        coo, stats = _preprocess_stack_numpy(stack, inputs, weights)
    coo.fwd_slots, coo.fwd_gains = construction_fwd_arrays(
        stack, inputs, weights, coo.divisors
    )
    return coo, stats


def _preprocess_stack_numpy(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray | Sequence],
    weights: Mapping[str, np.ndarray] | None,
) -> tuple[CooBatch, InputStats]:
    """The numpy backend of build_coo (no construction-order arrays)."""
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    F = stack.num_features
    B = stack.batch_size
    Bl = B // D
    S_l = F * Bl
    sink = stack.sink_slot

    all_d, all_s, all_slot, all_seg, all_gain = [], [], [], [], []
    divisors = np.ones((D, S_l), np.float32)

    for fspec in stack.features:
        ids = np.asarray(inputs[fspec.name])
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape[0] != B:
            raise ValueError(
                f"Feature {fspec.name}: expected global batch {B}, got "
                f"{ids.shape[0]}."
            )
        w = None if weights is None else weights.get(fspec.name)
        if w is None:
            w = np.ones(ids.shape, np.float32)
        else:
            w = np.asarray(w, np.float32)
            if w.ndim == 1:
                w = w[:, None]
            if w.shape != ids.shape:
                raise ValueError(
                    f"Feature {fspec.name}: weights shape {w.shape} != ids "
                    f"shape {ids.shape}."
                )

        tspec = stack.table_spec(fspec.table_name)
        b = np.repeat(np.arange(B, dtype=np.int64), ids.shape[1])
        r = ids.reshape(-1).astype(np.int64)
        g = w.reshape(-1)
        keep = (g != 0) & (r >= 0) & (r < tspec.vocabulary_size)
        b, r, g = b[keep], r[keep], g[keep]

        d = b // Bl
        seg = (b % Bl) * F + fspec.feature_index
        all_d.append(d)
        all_s.append((r + tspec.rotation) % D)
        all_slot.append(tspec.local_offset + r // D)
        all_seg.append(seg)
        all_gain.append(g)

        seg_w = np.zeros((D, Bl), np.float32)
        if tspec.combiner == "sqrtn":
            np.add.at(seg_w, (d, b % Bl), g * g)
            seg_w = np.sqrt(seg_w)
        elif tspec.combiner == "mean":
            np.add.at(seg_w, (d, b % Bl), g)
        else:  # sum
            seg_w = np.ones((D, Bl), np.float32)
        seg_w[seg_w == 0] = 1.0
        divisors[:, fspec.feature_index :: F] = seg_w

    d = np.concatenate(all_d) if all_d else np.zeros(0, np.int64)
    s = np.concatenate(all_s) if all_s else np.zeros(0, np.int64)
    slot = np.concatenate(all_slot) if all_slot else np.zeros(0, np.int64)
    seg = np.concatenate(all_seg) if all_seg else np.zeros(0, np.int64)
    gain = np.concatenate(all_gain) if all_gain else np.zeros(0, np.float32)

    # Bucket by (src device, dst shard), slot-ascending within a bucket,
    # original order for full ties; pad to capacity C.
    order = np.lexsort((slot, s, d))
    d, s, slot, seg, gain = (
        d[order], s[order], slot[order], seg[order], gain[order]
    )
    bucket = d * D + s
    starts = np.searchsorted(bucket, np.arange(D * D))
    rank = np.arange(len(bucket)) - starts[bucket]

    within = rank < C
    dropped = int((~within).sum())
    counts = np.bincount(bucket, minlength=D * D)
    max_ids = int(counts.max()) if len(counts) else 0

    send_slots = np.full((D, D, C), sink, np.int32)
    send_segs = np.zeros((D, D, C), np.int32)
    send_gains = np.zeros((D, D, C), np.float32)
    dd, ss, rr = d[within], s[within], rank[within]
    send_slots[dd, ss, rr] = slot[within]
    send_segs[dd, ss, rr] = seg[within]
    send_gains[dd, ss, rr] = gain[within]

    # Fold the combiner divisor into the gains (padding stays 0) and
    # globalize segment ids to src * S_l + seg.
    send_gains = send_gains / divisors[
        np.arange(D, dtype=np.int64)[:, None, None], send_segs
    ]
    send_segs = send_segs + (
        np.arange(D, dtype=np.int32)[:, None, None] * S_l
    )

    # Per-shard dedup for the backward pass.
    unique_slots = np.full((D, U), sink, np.int32)
    entry_unique = np.full((D, D * C), U, np.int32)
    max_unique = 0
    for e in range(D):
        recv_slots = send_slots[:, e, :].reshape(-1)  # [D*C]
        # Membership is bucket occupancy (slot != sink), not gain != 0.
        real = recv_slots != sink
        vals = recv_slots[real]
        if D == 1 and len(vals):
            # Already slot-sorted: adjacency dedup.
            new_u = np.empty(len(vals), bool)
            new_u[0] = True
            np.not_equal(vals[1:], vals[:-1], out=new_u[1:])
            uniq = vals[new_u]
            inv = np.cumsum(new_u) - 1
        else:
            uniq, inv = np.unique(vals, return_inverse=True)
        max_unique = max(max_unique, len(uniq))
        n = min(len(uniq), U - 1)  # last unique slot is the sink
        unique_slots[e, :n] = uniq[:n]
        inv = np.where(inv < n, inv, U)
        entry_unique[e, np.nonzero(real)[0]] = inv

    unique_overflow = max(0, max_unique - (U - 1))
    stats = InputStats(
        max_ids_per_bucket=max_ids,
        max_unique_per_shard=max_unique,
        dropped_ids=dropped + unique_overflow,
    )
    return (
        CooBatch(
            send_slots=send_slots,
            send_segs=send_segs,
            send_gains=send_gains,
            unique_slots=unique_slots,
            entry_unique=entry_unique,
            divisors=divisors,
        ),
        stats,
    )
