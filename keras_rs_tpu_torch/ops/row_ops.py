"""Row kernels of the embedding update: wrappers and plain versions.

Counterpart of keras_rs_tpu/ops/row_ops.py. The Hopper kernels are CUDA
C++ in csrc/row_ops.cu; this module holds their wrappers, launch counts
and plain PyTorch versions. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.

B1, `apply_scatter_row_blocks` (Pallas `_make_rmw_kernel`): `packed` is
the [R, k, dim] f32 state (table row + k-1 optimizer-slot rows per
logical row). For each live position i < n_valid,
`packed[idx[i]] = optimizer.apply(packed[idx[i]], grads[i])`, in place.
The live prefix of `idx` holds no duplicates and lies in [0, R): the
plain version raises on an index outside it, the kernel skips it.
Positions past n_valid (the dedup list's sink padding) are left alone.
Unlike the JAX function, the caller passes no gathered blocks: the kernel
reads each row's block itself.

B2-B4, one kernel (`scatter_rows_kernel`) behind three wrappers:
`scatter_rows` (B3, `_scatter_kernel`): `table[idx[i]] = rows[i]`;
`_scatter_rows_multi` (B4, `_make_multi_kernel`): the same for 2 to 4
arrays sharing one idx; `scatter_row_blocks` (B2, `_block_kernel`):
`packed[idx[i]] = blocks[i]` for [k, dim] row groups. A row is everything
after the leading dimension, so [R] arrays (row-wise slots) are scattered
too, and the streams of one call may differ in width and type (they share
the row count R). `idx` is int32, unique on the live prefix, or repeats
an index only with identical bytes (the sink padding). `n_valid` (a
one-element int32 tensor, or None for all N) bounds the live prefix; the
plain version writes the tail rows back unchanged, so it needs no host
read of it, and the kernel skips them. The JAX functions return new
arrays; these update the tables in place and return them.
`scatter_rows_unique`, `scatter_rows_unique_multi` and
`scatter_row_blocks_unique` cast the rows to the table's dtype first
(round to nearest) and are what the lookup calls.

The split update of bf16 tables, one kernel (`apply_split_rows_kernel`)
behind two wrappers; it replaces no Pallas kernel (the JAX package leaves
this chain to XLA, lookup.py:448-523). `apply_split_rows`: for each live
position i < n_valid, row-wise Adagrad on `table[idx[i]]` (bf16) and
`acc[idx[i]]` (f32, updated in place) from the gradient row `grads[i]`,
the new row rounded stochastically into a [N, dim] bf16 buffer that the
row scatter (B3) then writes to the table. `round_split_rows`: only the
rounding, of new f32 rows another optimizer computed. The rounding's bits
come from Philox4x32-10 (`philox4x32_10`) keyed with `seed + step`, the
step read from the stack's step tensor on the device, and counted by (row
index, column // 4), so the bits of a row depend neither on its place in
`idx` nor on the launch. Rows of the buffer past n_valid are unspecified
(the scatter skips them).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from keras_rs_tpu_torch.kernels import loader
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.ops.quant import stochastic_round_bf16_bits

#: Optimizer codes of B1's functors in csrc/row_ops.cu: the packed stacks
#: whose update B1 fuses (others gather, apply and scatter with B2).
FUSED_OPTIMIZERS = {"adagrad": 0, "sgd": 1}
#: Streams the scatter kernel takes in one launch.
MAX_STREAMS = 4
#: Optimizers whose split update of a bf16 table runs whole in
#: `apply_split_rows`; the others' new rows are rounded by
#: `round_split_rows`.
SPLIT_FUSED_OPTIMIZERS = ("rowwise_adagrad",)
#: Widest row the split kernel takes (kMaxSplitDim in csrc/row_ops.cu).
MAX_SPLIT_DIM = 1024


def _check(packed, idx, grads, scalars, optimizer, n_valid) -> None:
    if packed.dtype != torch.float32 or packed.ndim != 3:
        raise ValueError(
            f"packed must be a float32 [R, k, dim] tensor, got "
            f"{packed.dtype} {tuple(packed.shape)}."
        )
    _, k, dim = packed.shape
    if k != 1 + len(optimizer.slot_names):
        raise ValueError(
            f"packed has {k} rows per block; {optimizer.name} needs "
            f"{1 + len(optimizer.slot_names)}."
        )
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise ValueError(f"idx must be int32 [N], got {idx.dtype} "
                         f"{tuple(idx.shape)}.")
    if grads.dtype != torch.float32 or tuple(grads.shape) != (
        idx.shape[0], dim
    ):
        raise ValueError(
            f"grads must be float32 {(idx.shape[0], dim)}, got "
            f"{grads.dtype} {tuple(grads.shape)}."
        )
    if scalars.dtype != torch.float32 or scalars.ndim != 1 or (
        scalars.numel() < 1
    ):
        raise ValueError("scalars must be a float32 [n >= 1] tensor.")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ValueError("n_valid must be a one-element int32 tensor.")
    tensors = (packed, idx, grads, scalars, n_valid)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            "packed, idx, grads, scalars and n_valid must share a device; "
            f"got {[str(t.device) for t in tensors]}."
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all arguments must be contiguous.")


def apply_scatter_row_blocks_reference(
    packed: torch.Tensor,  # [R, k, dim] f32, updated in place
    idx: torch.Tensor,  # [N] int32, unique on the live prefix
    grads: torch.Tensor,  # [N, dim] f32 summed row gradients
    scalars: torch.Tensor,  # [n] f32; scalars[0] is the step counter
    optimizer: opt_lib.EmbeddingOptimizer,  # its rate may be a schedule
    n_valid: torch.Tensor,  # one-element int32: live prefix length
) -> torch.Tensor:
    """Plain PyTorch version: gather, `optimizer.apply`, `index_copy_`.

    Tail positions (>= n_valid) write their own block back unchanged, so
    the function needs no host read of n_valid.
    """
    N = idx.shape[0]
    if N == 0:
        return packed
    idx64 = idx.long()
    live = torch.arange(N, device=idx.device) < n_valid.reshape(())
    blk = packed[idx64]  # [N, k, dim]
    names = optimizer.slot_names
    new_rows, new_slots = optimizer.apply(
        blk[:, 0],
        grads,
        {name: blk[:, 1 + i] for i, name in enumerate(names)},
        scalars[0],
    )
    new_blk = torch.stack(
        [new_rows] + [new_slots[name] for name in names], dim=1
    )
    packed.index_copy_(
        0, idx64, torch.where(live[:, None, None], new_blk, blk)
    )
    return packed


def apply_scatter_row_blocks(
    packed: torch.Tensor,
    idx: torch.Tensor,
    grads: torch.Tensor,
    scalars: torch.Tensor,
    optimizer: opt_lib.EmbeddingOptimizer,
    n_valid: torch.Tensor,
) -> torch.Tensor:
    """`packed[idx[i]] = optimizer.apply(packed[idx[i]], grads[i])` for
    i < n_valid, in place; returns `packed`.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    of csrc/row_ops.cu (Adagrad or SGD) or raise. A schedule (callable
    learning rate) is evaluated on the device at scalars[0] and read by
    the kernel from its scalars buffer. Every launch adds one to
    `apply_scatter_row_blocks.launches`.
    """
    _check(packed, idx, grads, scalars, optimizer, n_valid)
    if packed.device.type == "cpu":
        return apply_scatter_row_blocks_reference(
            packed, idx, grads, scalars, optimizer, n_valid
        )
    if packed.device.type != "cuda":
        raise ValueError(
            f"apply_scatter_row_blocks runs on cpu or cuda, not "
            f"{packed.device}."
        )
    code = FUSED_OPTIMIZERS.get(optimizer.name)
    if code is None:
        raise ValueError(
            f"The CUDA kernel supports {sorted(FUSED_OPTIMIZERS)}, not "
            f"{optimizer.name}."
        )
    if packed.shape[2] % 4:
        raise ValueError("The CUDA kernel needs dim % 4 == 0 (float4 rows).")
    if packed.data_ptr() % 16 or grads.data_ptr() % 16:
        raise ValueError(
            "The CUDA kernel needs packed and grads to start on a 16-byte "
            "boundary (float4 loads)."
        )
    # A schedule's rate is computed on the device and handed over as
    # scalars[1], which the kernel reads (lr_index 1): no host read.
    lr, lr_index = optimizer.learning_rate, -1
    if callable(lr):
        scalars = torch.cat([scalars[:1], optimizer.lr(scalars[0])[None]])
        lr, lr_index = 0.0, 1
    fn = _kernel_fn()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(
            packed.data_ptr(),
            idx.data_ptr(),
            grads.data_ptr(),
            scalars.data_ptr(),
            n_valid.data_ptr(),
            packed.shape[0],
            idx.shape[0],
            packed.shape[1],
            packed.shape[2],
            code,
            float(lr),
            lr_index,
            float(getattr(optimizer, "epsilon", 0.0)),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"krt_apply_scatter_row_blocks failed with code {err} "
            "(-1: unsupported optimizer/k or grid; else a cudaError_t)."
        )
    apply_scatter_row_blocks.launches += 1
    return packed


apply_scatter_row_blocks.launches = 0


@functools.cache
def _kernel_fn():
    fn = loader.load("row_ops").lib.krt_apply_scatter_row_blocks
    fn.argtypes = [
        ctypes.c_void_p,  # packed
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # grads
        ctypes.c_void_p,  # scalars
        ctypes.c_void_p,  # n_valid
        ctypes.c_longlong,  # num_rows
        ctypes.c_longlong,  # n
        ctypes.c_int,  # k
        ctypes.c_int,  # dim
        ctypes.c_int,  # optimizer code
        ctypes.c_float,  # lr
        ctypes.c_int,  # lr_index: -1, or the scalars entry holding lr
        ctypes.c_float,  # eps
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


# --- B2-B4: the row scatter --------------------------------------------------


def _check_scatter(tables, idx, rows_list, n_valid) -> None:
    if not tables or len(tables) != len(rows_list):
        raise ValueError("tables and rows_list must pair up (non-empty).")
    if len(tables) > MAX_STREAMS:
        raise ValueError(
            f"At most {MAX_STREAMS} streams per call, got {len(tables)}."
        )
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise ValueError(f"idx must be int32 [N], got {idx.dtype} "
                         f"{tuple(idx.shape)}.")
    if n_valid is not None and (
        n_valid.dtype != torch.int32 or n_valid.numel() != 1
    ):
        raise ValueError("n_valid must be a one-element int32 tensor.")
    for t, r in zip(tables, rows_list):
        if t.ndim < 1 or t.shape[0] != tables[0].shape[0]:
            raise ValueError(
                "Every table must have the same leading row count; got "
                f"{[tuple(t.shape) for t in tables]}."
            )
        want = (idx.shape[0],) + tuple(t.shape[1:])
        if tuple(r.shape) != want or r.dtype != t.dtype:
            raise ValueError(
                f"rows must be {t.dtype} {want}, got {r.dtype} "
                f"{tuple(r.shape)}."
            )
    tensors = [*tables, *rows_list, idx] + (
        [n_valid] if n_valid is not None else []
    )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            "tables, rows, idx and n_valid must share a device; got "
            f"{sorted({str(t.device) for t in tensors})}."
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all arguments must be contiguous.")


def scatter_rows_reference(
    tables: list[torch.Tensor],
    idx: torch.Tensor,
    rows_list: list[torch.Tensor],
    n_valid: torch.Tensor | None = None,
) -> None:
    """Plain PyTorch version of B2-B4, in place: `index_copy_` per
    stream, with the tail (positions >= n_valid) writing each target
    row's own bytes back, so n_valid is never read on the host."""
    N = idx.shape[0]
    idx64 = idx.long()
    live = (
        None if n_valid is None
        else torch.arange(N, device=idx.device) < n_valid.reshape(())
    )
    for t, r in zip(tables, rows_list):
        if live is not None:
            r = torch.where(
                live.view((N,) + (1,) * (r.ndim - 1)), r, t[idx64]
            )
        t.index_copy_(0, idx64, r)


def _scatter(counter, tables, idx, rows_list, n_valid) -> None:
    """Checks, then the plain version (CPU) or one kernel launch (CUDA)
    that adds one to `counter.launches`."""
    _check_scatter(tables, idx, rows_list, n_valid)
    N = idx.shape[0]
    if N == 0:
        return
    device = idx.device
    if device.type == "cpu":
        scatter_rows_reference(tables, idx, rows_list, n_valid)
        return
    if device.type != "cuda":
        raise ValueError(f"The row scatter runs on cpu or cuda, not {device}.")
    row_bytes = [math.prod(t.shape[1:]) * t.element_size() for t in tables]
    if any(b % 2 for b in row_bytes):
        raise ValueError(
            f"The CUDA kernel copies 2-byte units; row bytes {row_bytes}."
        )
    k = len(tables)
    fn = _scatter_fn()
    with torch.cuda.device(device):
        err = fn(
            k,
            (ctypes.c_void_p * k)(*[t.data_ptr() for t in tables]),
            (ctypes.c_void_p * k)(*[r.data_ptr() for r in rows_list]),
            (ctypes.c_longlong * k)(*row_bytes),
            idx.data_ptr(),
            None if n_valid is None else n_valid.data_ptr(),
            tables[0].shape[0],
            N,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"krt_scatter_rows failed with code {err} (-1: unsupported "
            "stream count, row width, alignment or grid; else a "
            "cudaError_t)."
        )
    counter.launches += 1


def scatter_rows(
    table: torch.Tensor,  # [R, ...], updated in place
    idx: torch.Tensor,  # [N] int32
    rows: torch.Tensor,  # [N, ...] of table's dtype
    n_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """B3: `table[idx[i]] = rows[i]` for i < n_valid, in place; returns
    `table`. Every launch adds one to `scatter_rows.launches`."""
    _scatter(scatter_rows, [table], idx, [rows], n_valid)
    return table


scatter_rows.launches = 0


def _scatter_rows_multi(
    tables: list[torch.Tensor],
    idx: torch.Tensor,
    rows_list: list[torch.Tensor],
    n_valid: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """B4: `tables[s][idx[i]] = rows_list[s][i]` for every stream s and
    i < n_valid, in one launch; in place. Every launch adds one to
    `_scatter_rows_multi.launches`."""
    _scatter(_scatter_rows_multi, list(tables), idx, list(rows_list),
             n_valid)
    return list(tables)


_scatter_rows_multi.launches = 0


def scatter_row_blocks(
    packed: torch.Tensor,  # [R, k, dim], updated in place
    idx: torch.Tensor,  # [N] int32
    blocks: torch.Tensor,  # [N, k, dim] of packed's dtype
    n_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """B2: `packed[idx[i]] = blocks[i]` ([k, dim] groups) for i <
    n_valid, in place; returns `packed`. Every launch adds one to
    `scatter_row_blocks.launches`."""
    if packed.ndim != 3:
        raise ValueError(
            f"packed must be [R, k, dim], got {tuple(packed.shape)}."
        )
    _scatter(scatter_row_blocks, [packed], idx, [blocks], n_valid)
    return packed


scatter_row_blocks.launches = 0


def scatter_rows_unique(table, idx, rows, n_valid=None) -> torch.Tensor:
    """`scatter_rows` after casting `rows` to the table's dtype."""
    return scatter_rows(table, idx, rows.to(table.dtype), n_valid)


def scatter_row_blocks_unique(packed, idx, blocks, n_valid=None):
    """`scatter_row_blocks` after casting `blocks` to the state's dtype."""
    return scatter_row_blocks(packed, idx, blocks.to(packed.dtype), n_valid)


def scatter_rows_unique_multi(
    tables: list[torch.Tensor],
    idx: torch.Tensor,
    rows_list: list[torch.Tensor],
    n_valid: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """`tables[s][idx[i]] = rows_list[s][i]` for every stream s: B3 for
    one stream, B4 for 2 to 4 in one launch. Rows are cast to each
    table's dtype; all tables share the row count."""
    if not tables or len(tables) != len(rows_list):
        raise ValueError("tables and rows_list must pair up (non-empty).")
    if len(tables) == 1:
        return [scatter_rows_unique(tables[0], idx, rows_list[0], n_valid)]
    rows_list = [r.to(t.dtype) for t, r in zip(tables, rows_list)]
    return _scatter_rows_multi(tables, idx, rows_list, n_valid)


@functools.cache
def _scatter_fn():
    fn = loader.load("row_ops").lib.krt_scatter_rows
    fn.argtypes = [
        ctypes.c_int,  # k
        ctypes.POINTER(ctypes.c_void_p),  # dst[k]
        ctypes.POINTER(ctypes.c_void_p),  # src[k]
        ctypes.POINTER(ctypes.c_longlong),  # row_bytes[k]
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # n_valid (None: all N)
        ctypes.c_longlong,  # num_rows
        ctypes.c_longlong,  # n
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


# --- The split update of bf16 tables -----------------------------------------

#: Philox4x32's round multipliers and key increments (Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
#: Rows whose rounding bits the plain version draws at once (512k rows of
#: 32 words in int64: 134 MB per temporary).
_ROUND_CHUNK_ROWS = 1 << 19


def _mulhilo(m: int, x):
    """(hi, lo): the 32-bit halves of the 64-bit product m * x, for x of
    32 bits held in int64. Multiplying by m's 16-bit halves keeps every
    product below 2^48, so nothing overflows int64."""
    p0 = x * (m & 0xFFFF)
    p1 = x * (m >> 16)
    return (p1 + (p0 >> 16)) >> 16, (((p1 & 0xFFFF) << 16) + p0) & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R(10,
    ...)): the four 32-bit words of `counter` (four ints or int64 tensors,
    broadcast together) under the two of `key`, each in [0, 2^32).
    Returns the four output words, as int64 tensors (or ints)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_rounding_bits(idx: torch.Tensor, dim: int, step: torch.Tensor,
                        seed: int) -> torch.Tensor:
    """[N, dim] int64 Philox words whose low 16 bits round row idx[i]:
    key `seed + int(step)` (step a one-element tensor, read on its
    device), counter (idx[i], column // 4, 0, 0), word column % 4."""
    key = seed + step.reshape(()).to(torch.int64)
    quads = torch.arange(-(-dim // 4), dtype=torch.int64, device=idx.device)
    words = philox4x32_10((idx.long()[:, None], quads[None, :], 0, 0),
                          (key & _MASK32, (key >> 32) & _MASK32))
    return torch.stack(words, dim=-1).reshape(idx.shape[0], -1)[:, :dim]


def _round_rows(x: torch.Tensor, idx: torch.Tensor, scalars: torch.Tensor,
                seed: int) -> torch.Tensor:
    """x [N, dim] f32 rounded stochastically to bf16 with the bits of
    `split_rounding_bits`, a chunk of rows at a time."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    for lo in range(0, x.shape[0], _ROUND_CHUNK_ROWS):
        hi = min(x.shape[0], lo + _ROUND_CHUNK_ROWS)
        bits = split_rounding_bits(idx[lo:hi], x.shape[1], scalars[:1], seed)
        out[lo:hi] = stochastic_round_bf16_bits(x[lo:hi], bits & 0xFFFF)
    return out


def _lane_tree_sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """sum(g^2, -1) [N] in the kernel's order: each of 32 lanes sums its
    columns (4l .. 4l + 3, then 128 more on, ...) from 0, then a halving
    tree over the lanes (lane l plus lane l + 16, ...)."""
    N, dim = g.shape
    width = -(-dim // 128) * 128
    sq = torch.zeros((N, width), dtype=torch.float32, device=g.device)
    sq[:, :dim] = g * g
    sq = sq.view(N, width // 128, 32, 4)
    s = torch.zeros((N, 32), dtype=torch.float32, device=g.device)
    for c in range(width // 128):
        for j in range(4):
            s = s + sq[:, c, :, j]
    half = 16
    while half:
        s = s[:, :half] + s[:, half : 2 * half]
        half //= 2
    return s[:, 0]


def _check_split(src, idx, scalars, n_valid, seed, table=None,
                 acc=None) -> None:
    if src.dtype != torch.float32 or src.ndim != 2:
        raise ValueError(f"rows / grads must be float32 [N, dim], got "
                         f"{src.dtype} {tuple(src.shape)}.")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (src.shape[0],):
        raise ValueError(f"idx must be int32 [{src.shape[0]}], got "
                         f"{idx.dtype} {tuple(idx.shape)}.")
    if scalars.dtype != torch.float32 or scalars.ndim != 1 or (
        scalars.numel() < 1
    ):
        raise ValueError("scalars must be a float32 [n >= 1] tensor.")
    if n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ValueError("n_valid must be a one-element int32 tensor.")
    if not 0 <= seed < 1 << 63:
        raise ValueError(f"seed must lie in [0, 2^63), got {seed}.")
    tensors = [src, idx, scalars, n_valid]
    if table is not None:
        if table.dtype != torch.bfloat16 or table.ndim != 2 or (
            table.shape[1] != src.shape[1]
        ):
            raise ValueError(
                f"table must be bfloat16 [R, {src.shape[1]}], got "
                f"{table.dtype} {tuple(table.shape)}.")
        if acc.dtype != torch.float32 or tuple(acc.shape) != (
            table.shape[0],
        ):
            raise ValueError(
                f"acc must be float32 [{table.shape[0]}], got {acc.dtype} "
                f"{tuple(acc.shape)}.")
        tensors += [table, acc]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            "The arguments must share a device; got "
            f"{sorted({str(t.device) for t in tensors})}.")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all arguments must be contiguous.")


def apply_split_rows_reference(
    table: torch.Tensor,  # [R, dim] bf16, read only
    acc: torch.Tensor,  # [R] f32 row-wise accumulator, updated in place
    idx: torch.Tensor,  # [N] int32, unique on the live prefix
    grads: torch.Tensor,  # [N, dim] f32 summed row gradients
    scalars: torch.Tensor,  # [n] f32; scalars[0] is the step counter
    optimizer: opt_lib.EmbeddingOptimizer,  # row-wise Adagrad
    n_valid: torch.Tensor,  # one-element int32: live prefix length
    seed: int,  # the Philox key less the step
) -> torch.Tensor:
    """Plain PyTorch version of `apply_split_rows`: RowWiseAdagrad.apply
    with the sum of squares in the kernel's order and the square root
    taken in f64 (correctly rounded, as the kernel's), then the rounding.
    Tail positions (>= n_valid) write their own accumulator back, so the
    function needs no host read of n_valid; their rows are computed but
    unspecified."""
    N = idx.shape[0]
    if N == 0:
        return torch.empty(grads.shape, dtype=torch.bfloat16,
                           device=grads.device)
    idx64 = idx.long()
    live = torch.arange(N, device=idx.device) < n_valid.reshape(())
    old = acc[idx64]
    new_acc = old + _lane_tree_sum_of_squares(grads)
    denom = torch.sqrt(new_acc.double()).float() + optimizer.epsilon
    new_rows = table[idx64].float() - optimizer.lr(scalars[0]) * (
        grads / denom[:, None])
    acc.index_copy_(0, idx64, torch.where(live, new_acc, old))
    return _round_rows(new_rows, idx, scalars, seed)


def round_split_rows_reference(
    rows: torch.Tensor,  # [N, dim] f32 new rows
    idx: torch.Tensor,  # [N] int32 rows of the table they go to
    scalars: torch.Tensor,  # [n] f32; scalars[0] is the step counter
    n_valid: torch.Tensor,  # one-element int32: live prefix length
    seed: int,
) -> torch.Tensor:
    """Plain PyTorch version of `round_split_rows`: every row rounded,
    those past n_valid unspecified."""
    return _round_rows(rows, idx, scalars, seed)


def _split(counter, table, acc, src, idx, scalars, optimizer, n_valid,
           seed) -> torch.Tensor:
    """One launch of the split kernel (apply when `table` is given) into
    a new [N, dim] bf16 buffer; adds one to `counter.launches`."""
    if src.device.type != "cuda":
        raise ValueError(f"The split update runs on cpu or cuda, not "
                         f"{src.device}.")
    N, dim = src.shape
    if dim > MAX_SPLIT_DIM:
        raise ValueError(f"The CUDA kernel takes rows of at most "
                         f"{MAX_SPLIT_DIM} columns, not {dim}.")
    out = torch.empty((N, dim), dtype=torch.bfloat16, device=src.device)
    if N == 0:
        return out
    lr, lr_index, eps = 0.0, -1, 0.0
    if optimizer is not None:
        lr, eps = optimizer.learning_rate, float(optimizer.epsilon)
        # A schedule's rate is computed on the device and handed over as
        # scalars[1], as for B1.
        if callable(lr):
            scalars = torch.cat([scalars[:1],
                                 optimizer.lr(scalars[0])[None]])
            lr, lr_index = 0.0, 1
    fn = _split_fn()
    with torch.cuda.device(src.device):
        err = fn(
            None if table is None else table.data_ptr(),
            None if acc is None else acc.data_ptr(),
            src.data_ptr(),
            out.data_ptr(),
            idx.data_ptr(),
            scalars.data_ptr(),
            n_valid.data_ptr(),
            0 if table is None else table.shape[0],
            N,
            dim,
            int(table is not None),
            float(lr),
            lr_index,
            eps,
            seed,
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"krt_split_rows failed with code {err} (-1: unsupported "
            "arguments or grid; else a cudaError_t).")
    counter.launches += 1
    return out


def apply_split_rows(
    table: torch.Tensor,
    acc: torch.Tensor,
    idx: torch.Tensor,
    grads: torch.Tensor,
    scalars: torch.Tensor,
    optimizer: opt_lib.EmbeddingOptimizer,
    n_valid: torch.Tensor,
    seed: int,
) -> torch.Tensor:
    """Row-wise Adagrad on the bf16 rows `table[idx[i]]` and accumulators
    `acc[idx[i]]` (in place) for i < n_valid; returns the new rows,
    rounded stochastically, as a [N, dim] bf16 buffer for the row
    scatter. `table` is not written.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    of csrc/row_ops.cu or raise. Every launch adds one to
    `apply_split_rows.launches`.
    """
    if optimizer.name not in SPLIT_FUSED_OPTIMIZERS:
        raise ValueError(f"apply_split_rows supports "
                         f"{list(SPLIT_FUSED_OPTIMIZERS)}, not "
                         f"{optimizer.name}.")
    _check_split(grads, idx, scalars, n_valid, seed, table, acc)
    if grads.device.type == "cpu":
        return apply_split_rows_reference(table, acc, idx, grads, scalars,
                                          optimizer, n_valid, seed)
    return _split(apply_split_rows, table, acc, grads, idx, scalars,
                  optimizer, n_valid, seed)


apply_split_rows.launches = 0


def round_split_rows(
    rows: torch.Tensor,
    idx: torch.Tensor,
    scalars: torch.Tensor,
    n_valid: torch.Tensor,
    seed: int,
) -> torch.Tensor:
    """The f32 rows [N, dim] bound for the table rows idx, rounded
    stochastically to bf16 with the bits of `apply_split_rows` (rows past
    n_valid unspecified). CPU tensors go to the plain version; CUDA
    tensors launch the kernel or raise. Every launch adds one to
    `round_split_rows.launches`."""
    _check_split(rows, idx, scalars, n_valid, seed)
    if rows.device.type == "cpu":
        return round_split_rows_reference(rows, idx, scalars, n_valid, seed)
    return _split(round_split_rows, None, None, rows, idx, scalars, None,
                  n_valid, seed)


round_split_rows.launches = 0


@functools.cache
def _split_fn():
    fn = loader.load("row_ops").lib.krt_split_rows
    fn.argtypes = [
        ctypes.c_void_p,  # table (None: round only)
        ctypes.c_void_p,  # acc (None: round only)
        ctypes.c_void_p,  # src: gradients or new rows
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # idx
        ctypes.c_void_p,  # scalars
        ctypes.c_void_p,  # n_valid
        ctypes.c_longlong,  # num_rows
        ctypes.c_longlong,  # n
        ctypes.c_int,  # dim
        ctypes.c_int,  # apply
        ctypes.c_float,  # lr
        ctypes.c_int,  # lr_index: -1, or the scalars entry holding lr
        ctypes.c_float,  # eps
        ctypes.c_uint64,  # seed
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn
