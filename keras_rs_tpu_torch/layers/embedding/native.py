"""ctypes binding of the C++ COO preprocessing engine.

Counterpart of keras_rs_tpu/layers/embedding/native.py over the same
source, native/coo_preprocess.cc, which g++ builds at first use into
build/keras_rs_tpu_torch/ (utils/native_build.py). The C call releases
the interpreter lock, so loader threads preprocess batches in parallel.
`preprocess_stack_native` returns what preprocessing.preprocess_stack's
numpy path returns, bit for bit, except the construction-order arrays,
which the caller adds (`preprocess_stack(..., backend="native")`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Mapping

import numpy as np

from keras_rs_tpu_torch.layers.embedding.preprocessing import (
    CooBatch,
    InputStats,
)
from keras_rs_tpu_torch.layers.embedding.stacking import TableStack
from keras_rs_tpu_torch.utils.native_build import load_shared_lib

_COMBINER_CODES = {"sum": 0, "mean": 1, "sqrtn": 2}
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def get_lib() -> ctypes.CDLL | None:
    """The engine, built and loaded on first call; None if it cannot be
    built (no g++)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = load_shared_lib("coo_preprocess")
        if lib is None:
            return None
        lib.coo_preprocess.restype = ctypes.c_int
        lib.coo_preprocess.argtypes = [
            ctypes.c_int64,                   # num_features
            ctypes.POINTER(_I64P),            # ids [F] -> [B * L_f]
            ctypes.POINTER(_F32P),            # weights [F] (or null)
            _I64P, _I64P, _I64P, _I64P,       # valences, vocabs,
                                              # offsets, rotations
            _I32P,                            # combiners
            ctypes.c_int64, ctypes.c_int64,   # B, D
            ctypes.c_int64, ctypes.c_int64,   # C, U
            ctypes.c_int64,                   # sink
            _I32P, _I32P, _F32P,              # send_slots/segs/gains
            _I32P, _I32P, _F32P,              # unique_slots,
                                              # entry_unique, divisors
            _I64P,                            # stats [3]
        ]
        _lib = lib
        # At DLRM valence the per-batch output buffers are several MB
        # each: keep them on the reusable heap, as the file reader's
        # columns are (idempotent; KRT_MALLOC_TUNING=0 opts out).
        from keras_rs_tpu_torch.data.native_io import (
            tune_malloc_for_large_columns,
        )

        tune_malloc_for_large_columns()
        return _lib


def available() -> bool:
    return get_lib() is not None


def preprocess_stack_native(
    stack: TableStack,
    inputs: Mapping[str, np.ndarray],
    weights: Mapping[str, np.ndarray] | None = None,
) -> tuple[CooBatch, InputStats]:
    """The numpy path's CooBatch (without fwd_slots / fwd_gains) and
    stats, from the C++ engine. Raises if the engine cannot be built."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "The C++ COO engine (native/coo_preprocess.cc) could not be "
            "built: g++ is missing or failed."
        )
    D = stack.num_shards
    C = stack.max_ids_per_partition
    U = stack.max_unique_ids_per_shard
    F = stack.num_features
    B = stack.batch_size
    S_l = F * (B // D)
    sink = stack.sink_slot

    keep = []  # every buffer the C call reads stays referenced here
    valences = np.zeros(F, np.int64)
    vocabs = np.zeros(F, np.int64)
    offsets = np.zeros(F, np.int64)
    rotations = np.zeros(F, np.int64)
    combiners = np.zeros(F, np.int32)
    id_ptrs = (_I64P * F)()
    w_ptrs = (_F32P * F)()
    for i, fspec in enumerate(stack.features):
        ids = np.ascontiguousarray(np.asarray(inputs[fspec.name]), np.int64)
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.shape[0] != B:
            raise ValueError(
                f"Feature {fspec.name}: expected batch {B}, got "
                f"{ids.shape[0]}."
            )
        w = None if weights is None else weights.get(fspec.name)
        if w is not None:
            w = np.ascontiguousarray(np.asarray(w), np.float32)
            if w.ndim == 1:
                w = w[:, None]
            if w.shape != ids.shape:
                raise ValueError(
                    f"Feature {fspec.name}: weights shape {w.shape} != "
                    f"ids shape {ids.shape}."
                )
        tspec = stack.table_spec(fspec.table_name)
        keep += [ids, w]
        valences[i] = ids.shape[1]
        vocabs[i] = tspec.vocabulary_size
        offsets[i] = tspec.local_offset
        rotations[i] = tspec.rotation
        combiners[i] = _COMBINER_CODES[tspec.combiner]
        id_ptrs[i] = ids.ctypes.data_as(_I64P)
        w_ptrs[i] = w.ctypes.data_as(_F32P) if w is not None else _F32P()

    send_slots = np.full((D, D, C), sink, np.int32)
    send_segs = np.zeros((D, D, C), np.int32)
    send_gains = np.zeros((D, D, C), np.float32)
    unique_slots = np.full((D, U), sink, np.int32)
    entry_unique = np.full((D, D * C), U, np.int32)  # U = drop sentinel
    divisors = np.ones((D, S_l), np.float32)
    stats = np.zeros(3, np.int64)

    rc = lib.coo_preprocess(
        F, id_ptrs, w_ptrs,
        valences.ctypes.data_as(_I64P), vocabs.ctypes.data_as(_I64P),
        offsets.ctypes.data_as(_I64P), rotations.ctypes.data_as(_I64P),
        combiners.ctypes.data_as(_I32P),
        B, D, C, U, sink,
        send_slots.ctypes.data_as(_I32P), send_segs.ctypes.data_as(_I32P),
        send_gains.ctypes.data_as(_F32P),
        unique_slots.ctypes.data_as(_I32P),
        entry_unique.ctypes.data_as(_I32P),
        divisors.ctypes.data_as(_F32P),
        stats.ctypes.data_as(_I64P),
    )
    if rc != 0:
        raise RuntimeError(f"coo_preprocess failed with code {rc}")

    # The numpy path's fold of the combiner divisor into the gains and
    # its globalized segment ids, the same expressions on the engine's
    # bit-identical raw arrays.
    send_gains = send_gains / divisors[
        np.arange(D, dtype=np.int64)[:, None, None], send_segs
    ]
    send_segs = send_segs + (
        np.arange(D, dtype=np.int32)[:, None, None] * S_l
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
        InputStats(
            max_ids_per_bucket=int(stats[0]),
            max_unique_per_shard=int(stats[1]),
            dropped_ids=int(stats[2]),
        ),
    )
