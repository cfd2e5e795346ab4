"""ctypes binding of the native TFRecord/Example column reader.

The port's copy of keras_rs_tpu/data/native_io.py, over the same source,
native/tfrecord_reader.cc, which g++ builds at first use into
build/keras_rs_tpu_torch/ (utils/native_build.py). `parse_file_batched`
parses every record of a TFRecord file natively, with the interpreter
lock released; data/criteo.py reads files through it and keeps the
Python reader (tfrecord.py) where the library cannot be built or a file
does not fit the fixed-width schema.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from keras_rs_tpu_torch.utils.native_build import load_shared_lib

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = load_shared_lib("tfrecord_reader")
        if lib is None:
            return None
        # Explicit argtypes: without them Python ints marshal as 32-bit
        # c_int, silently masking out_cap for >2 GB column buffers (the
        # real-Criteo regime) and corrupting the sizing handshake.
        lib.tfrec_parse_file2.restype = ctypes.c_long
        lib.tfrec_parse_file2.argtypes = [
            ctypes.c_char_p,                     # path
            ctypes.c_long,                       # num_keys
            ctypes.POINTER(ctypes.c_char_p),     # keys
            ctypes.POINTER(ctypes.c_long),       # key_lens
            ctypes.POINTER(ctypes.c_uint8),      # out buffer
            ctypes.c_long,                       # out_cap
            ctypes.c_long,                       # n_cap
            ctypes.POINTER(ctypes.c_long),       # offsets
            ctypes.POINTER(ctypes.c_long),       # kinds (long in v2)
            ctypes.POINTER(ctypes.c_long),       # needed
            ctypes.POINTER(ctypes.c_long),       # nrec
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _parse_raw(path: str, keys: list[str]):
    """Parses one file natively; returns (n, buf, offsets, kinds).

    Two native passes: the first sizes the output, the second fills
    arrays of exactly that size.
    """
    lib = get_lib()
    if lib is None:
        raise OSError("native TFRecord reader unavailable")
    nk = len(keys)
    key_bytes = [k.encode() for k in keys]
    key_arr = (ctypes.c_char_p * nk)(*key_bytes)
    len_arr = (ctypes.c_long * nk)(*[len(k) for k in key_bytes])
    needed = ctypes.c_long(0)
    nrec = ctypes.c_long(0)
    rc = lib.tfrec_parse_file2(
        path.encode(), nk, key_arr, len_arr,
        None, 0, 0, None, None,
        ctypes.byref(needed), ctypes.byref(nrec),
    )
    if rc < 0:
        raise OSError(f"native TFRecord sizing pass failed ({rc}): {path}")
    n_cap = int(nrec.value)
    buf = np.empty(max(int(needed.value), 1), np.uint8)
    offsets = np.empty(n_cap * nk + 1, np.int64)
    kinds = np.empty(max(n_cap * nk, 1), np.int64)
    rc = lib.tfrec_parse_file2(
        path.encode(), nk, key_arr, len_arr,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(buf), n_cap,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        ctypes.byref(needed), ctypes.byref(nrec),
    )
    if rc < 0:
        raise OSError(f"native TFRecord parse failed ({rc}): {path}")
    n = int(nrec.value)
    return n, buf, offsets[: n * nk + 1], kinds[: max(n * nk, 1)]


def parse_file_batched(
    path: str, keys: list[str]
) -> tuple[int, dict[str, tuple[int, np.ndarray]]] | None:
    """Whole-file COLUMN extraction for fixed-width schemas.

    When every record stores the same byte width per key (true for
    Criteo's decode_raw features), the output buffer is one regular
    [n, record_stride] matrix and each key's column falls out as a
    single reshape+slice — no per-record Python at all. Returns
    (n_records, {key: (kind, array)}) with arrays shaped [n, elems]
    (uint8 for BytesList, f32 for FloatList, i64 for Int64List), or
    None when widths vary / keys are missing (caller falls back to the
    per-row API).

    Float/int columns are contiguous copies; BytesList (kind 0) columns
    are row-strided views into the file's parse buffer.
    """
    n, buf, offsets, kinds = _parse_raw(path, keys)
    nk = len(keys)
    if n == 0:
        return 0, {}
    kinds2 = kinds[: n * nk].reshape(n, nk)
    if (kinds2 < 0).any() or (kinds2 != kinds2[0]).any():
        return None
    lens = np.diff(offsets).reshape(n, nk)
    if (lens != lens[0]).any():
        return None
    widths = lens[0]
    stride = int(widths.sum())
    if stride == 0 or len(buf) < n * stride:
        return None
    mat = buf[: n * stride].reshape(n, stride)
    out: dict[str, tuple[int, np.ndarray]] = {}
    col_off = 0
    for k, key in enumerate(keys):
        w = int(widths[k])
        kind = int(kinds2[0, k])
        col = mat[:, col_off : col_off + w]
        if kind == 1:
            col = np.ascontiguousarray(col).view("<f4")
        elif kind == 2:
            col = np.ascontiguousarray(col).view("<i8")
        out[key] = (kind, col)
        col_off += w
    return n, out
