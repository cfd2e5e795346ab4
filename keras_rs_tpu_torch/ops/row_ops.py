"""Fused optimizer-apply + row-block scatter for the packed embedding state.

Counterpart of keras_rs_tpu/ops/row_ops.py::apply_scatter_row_blocks
(Pallas kernel `_make_rmw_kernel`). The Hopper kernel is CUDA C++ in
csrc/row_ops.cu; this module holds its wrapper and its plain PyTorch
version.

Contract: `packed` is the [R, k, dim] f32 state (table row + k-1
optimizer-slot rows per logical row). For each live position
i < n_valid, `packed[idx[i]] = optimizer.apply(packed[idx[i]], grads[i])`,
in place. The live prefix of `idx` holds no duplicates and lies in
[0, R): the plain version raises on an index outside it, the kernel
skips it. Positions past n_valid (the dedup list's sink padding) are
left alone. Unlike the JAX
function, the caller passes no gathered blocks: the kernel reads each
row's block itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from keras_rs_tpu_torch.kernels import loader
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib

#: Optimizer codes of csrc/row_ops.cu.
_KERNEL_OPTIMIZERS = {"adagrad": 0, "sgd": 1}


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
    optimizer: opt_lib.EmbeddingOptimizer,
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
    of csrc/row_ops.cu (Adagrad or SGD) or raise. Every launch adds one
    to `apply_scatter_row_blocks.launches`.
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
    code = _KERNEL_OPTIMIZERS.get(optimizer.name)
    if code is None:
        raise ValueError(
            f"The CUDA kernel supports {sorted(_KERNEL_OPTIMIZERS)}, not "
            f"{optimizer.name}."
        )
    if packed.shape[2] % 4:
        raise ValueError("The CUDA kernel needs dim % 4 == 0 (float4 rows).")
    if packed.data_ptr() % 16 or grads.data_ptr() % 16:
        raise ValueError(
            "The CUDA kernel needs packed and grads to start on a 16-byte "
            "boundary (float4 loads)."
        )
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
            float(optimizer.learning_rate),
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
        ctypes.c_float,  # eps
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn
