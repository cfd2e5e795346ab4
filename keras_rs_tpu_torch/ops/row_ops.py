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
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from keras_rs_tpu_torch.kernels import loader
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib

#: Optimizer codes of B1's functors in csrc/row_ops.cu: the packed stacks
#: whose update B1 fuses (others gather, apply and scatter with B2).
FUSED_OPTIMIZERS = {"adagrad": 0, "sgd": 1}
#: Streams the scatter kernel takes in one launch.
MAX_STREAMS = 4


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
