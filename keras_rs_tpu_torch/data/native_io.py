"""ctypes binding of the native TFRecord/Example column reader.

The port's copy of keras_rs_tpu/data/native_io.py, over the same source,
native/tfrecord_reader.cc, which g++ builds at first use into
build/keras_rs_tpu_torch/ (utils/native_build.py). Every parse runs
natively over a whole file with the interpreter lock released:

- `parse_file_batched`: the generic column path. One pass once the
  first file of a key set has taught the size estimate (`_est_cache`),
  into thread-local buffers that grow and are reused (`_pooled`).
- `parse_file_fixed`: one pass straight into each key's final
  contiguous array, for files of a declared (kind, width) schema.
- `parse_file_columns`: per-record dicts over private buffers.

data/criteo.py reads files through the first two and keeps the Python
reader (tfrecord.py) where the library cannot be built or a file does
not fit the fixed-width schema.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Any

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
        lib.tfrec_parse_file_cols.restype = ctypes.c_long
        lib.tfrec_parse_file_cols.argtypes = [
            ctypes.c_char_p,                     # path
            ctypes.c_long,                       # num_keys
            ctypes.POINTER(ctypes.c_char_p),     # keys
            ctypes.POINTER(ctypes.c_long),       # key_lens
            ctypes.POINTER(ctypes.c_void_p),     # dsts
            ctypes.POINTER(ctypes.c_long),       # widths
            ctypes.POINTER(ctypes.c_long),       # kinds expected
            ctypes.c_long,                       # n_cap
            ctypes.POINTER(ctypes.c_long),       # nrec
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# Learned (bytes_out / bytes_in, records / bytes_in) ratios per key
# set: after the first file of a key set, later files parse in ONE
# native pass (capacities guessed with a 15% margin; an undersized guess
# returns -2 / -3 with the exact sizes, so one retry always fits).
_est_lock = threading.Lock()
_est_cache: dict[tuple, tuple[float, float]] = {}

# Thread-local grow-only buffers: a fresh multi-hundred-MB np.empty per
# file pays a page-fault storm as large as the parse itself. Views into
# them die inside the SAME worker call that produced them (callers copy
# while converting columns to batches, before the thread parses its next
# file), so reuse per thread is safe under the prefetch pool.
_tls = threading.local()

_malloc_tuned = False


def tune_malloc_for_large_columns() -> bool:
    """Keep column buffers of tens of MB on the reusable glibc heap.

    `parse_file_fixed` hands out PRIVATE arrays per file (they escape
    into batches, so the thread-local buffers cannot serve them). Above
    glibc's mmap threshold every such np.empty is a fresh mmap, unmapped
    again on free, so the native parse writing into it pays a page-fault
    storm. mallopt(M_MMAP_THRESHOLD / M_TRIM_THRESHOLD, 1 GiB) makes
    those buffers heap chunks that later files reuse; what stays held is
    bounded by the files in flight. Process-wide. Opt out with
    KRT_MALLOC_TUNING=0. Idempotent; True when applied."""
    global _malloc_tuned
    if _malloc_tuned:
        return True
    if os.environ.get("KRT_MALLOC_TUNING", "1") == "0":
        return False
    try:
        libc = ctypes.CDLL(None)
        m_trim, m_mmap = -1, -3  # glibc malloc.h constants
        ok = libc.mallopt(ctypes.c_int(m_mmap), ctypes.c_int(1 << 30))
        ok &= libc.mallopt(ctypes.c_int(m_trim), ctypes.c_int(1 << 30))
    except (OSError, AttributeError):  # no glibc (no mallopt)
        return False
    _malloc_tuned = bool(ok)
    return _malloc_tuned


def fast_contig(col: np.ndarray) -> np.ndarray:
    """Contiguous copy of a row-strided 2-D view: np.empty and one row
    assignment per row (a file's protos: a handful of memcpys), where
    `np.ascontiguousarray` on a column view of a wide matrix can fall
    onto a slow path. Other ranks go to `np.ascontiguousarray`."""
    if col.ndim != 2:
        return np.ascontiguousarray(col)
    out = np.empty(col.shape, col.dtype)
    for i in range(col.shape[0]):
        out[i] = col[i]
    return out


def _pooled(tag: str, size: int, dtype) -> np.ndarray:
    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = _tls.pool = {}
    arr = pool.get(tag)
    if arr is None or arr.shape[0] < size:
        arr = pool[tag] = np.empty(int(size * 1.1) + 16, dtype)
    return arr[:size]


def _alloc(tag: str, size: int, dtype, pooled: bool) -> np.ndarray:
    if pooled:
        return _pooled(tag, size, dtype)
    return np.empty(max(int(size), 1), dtype)[:size]


def _key_arrays(keys: list[str]):
    key_bytes = [k.encode() for k in keys]
    return (
        (ctypes.c_char_p * len(keys))(*key_bytes),
        (ctypes.c_long * len(keys))(*[len(k) for k in key_bytes]),
    )


def _parse_raw(path: str, keys: list[str], pooled: bool = True):
    """Parses one file natively; returns (n, buf, offsets, kinds).

    The first file of a key set takes a sizing pass and then a fill
    pass; later ones one pass at the estimated sizes (a second at the
    exact sizes when the estimate was short). `pooled=True` writes into
    the thread-local buffers: the arrays are valid only until the SAME
    thread parses another file with the same key set. `pooled=False`
    allocates private buffers, safe to hold.
    """
    lib = get_lib()
    if lib is None:
        raise OSError("native TFRecord reader unavailable")
    nk = len(keys)
    key_arr, len_arr = _key_arrays(keys)
    try:
        fsize = max(os.path.getsize(path), 1)
    except OSError:  # the native call below reports the missing file
        fsize = 1
    needed = ctypes.c_long(0)
    nrec = ctypes.c_long(0)
    cache_key = tuple(keys)
    with _est_lock:
        est = _est_cache.get(cache_key)
    if est is None:
        rc = lib.tfrec_parse_file2(
            path.encode(), nk, key_arr, len_arr,
            None, 0, 0, None, None,
            ctypes.byref(needed), ctypes.byref(nrec),
        )
        if rc < 0:
            raise OSError(
                f"native TFRecord sizing pass failed ({rc}): {path}")
        cap, n_cap = int(needed.value), int(nrec.value)
    else:
        cap = int(est[0] * fsize * 1.15) + 4096
        n_cap = int(est[1] * fsize * 1.15) + 16

    for _ in range(2):
        buf = _alloc(f"buf:{cache_key}", max(cap, 1), np.uint8, pooled)
        offsets = _alloc(f"off:{cache_key}", n_cap * nk + 1, np.int64,
                         pooled)
        kinds = _alloc(f"kind:{cache_key}", max(n_cap * nk, 1), np.int64,
                       pooled)
        rc = lib.tfrec_parse_file2(
            path.encode(), nk, key_arr, len_arr,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf), n_cap,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            ctypes.byref(needed), ctypes.byref(nrec),
        )
        if rc >= 0:
            n = int(nrec.value)
            with _est_lock:
                _est_cache[cache_key] = (int(needed.value) / fsize,
                                         n / fsize)
            return n, buf, offsets[: n * nk + 1], kinds[: max(n * nk, 1)]
        if rc not in (-2, -3):
            raise OSError(f"native TFRecord parse failed ({rc}): {path}")
        # The estimate was short: the call reported the exact sizes.
        cap, n_cap = int(needed.value), int(nrec.value)
    raise OSError(f"native TFRecord parse failed ({rc}): {path}")


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

    LIFETIME: float/int columns are private copies. BytesList (kind 0)
    columns are row-strided VIEWS into the calling thread's pooled parse
    buffer, valid only until that thread parses another file with the
    same key set: a caller copies them out first, as data/criteo.py does
    in the same worker call.
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
            col = fast_contig(col).view("<f4")
        elif kind == 2:
            col = fast_contig(col).view("<i8")
        out[key] = (kind, col)
        col_off += w
    return n, out


def parse_file_fixed(
    path: str,
    keys: list[str],
    schema: list[tuple[int, int]],
    n_cap: int,
) -> tuple[int, dict[str, tuple[int, np.ndarray]]] | None:
    """One-pass parse straight into final column-contiguous arrays.

    `schema` declares, per key, (kind, cell byte width), as learned from
    a first `parse_file_batched` call on the same dataset; `n_cap` is
    the expected record count. The native pass writes record r's cell
    for key k at row r of a PRIVATE [n, width] array per key, so the
    per-column copy out of the interleaved buffer that
    `parse_file_batched` consumers pay never happens. Arrays are typed
    by kind (uint8 for BytesList, f32 for FloatList, i64 for Int64List),
    contiguous, and safe to hold. A file of more than `n_cap` records is
    parsed again at its exact count.

    Returns (n_records, {key: (kind, array[:n])}); None when the file
    deviates from the declared schema (the caller falls back to the
    generic path); raises OSError on IO or parse errors.
    """
    lib = get_lib()
    if lib is None:
        return None
    nk = len(keys)
    key_arr, len_arr = _key_arrays(keys)
    width_arr = (ctypes.c_long * nk)(*[w for _, w in schema])
    kind_arr = (ctypes.c_long * nk)(*[k for k, _ in schema])
    nrec = ctypes.c_long(0)
    for _ in range(2):
        arrs: list[np.ndarray] = []
        dsts = (ctypes.c_void_p * nk)()
        for i, (kind, w) in enumerate(schema):
            if kind == 1:
                a = np.empty((n_cap, w // 4), "<f4")
            elif kind == 2:
                a = np.empty((n_cap, w // 8), "<i8")
            else:
                a = np.empty((n_cap, w), np.uint8)
            arrs.append(a)
            dsts[i] = a.ctypes.data
        rc = lib.tfrec_parse_file_cols(
            path.encode(), nk, key_arr, len_arr,
            dsts, width_arr, kind_arr, n_cap, ctypes.byref(nrec),
        )
        if rc >= 0:
            n = int(nrec.value)
            return n, {k: (schema[i][0], arrs[i][:n])
                       for i, k in enumerate(keys)}
        if rc == -4:
            return None  # a schema deviation: the generic path's file
        if rc != -3:
            break
        n_cap = int(nrec.value)  # exact: the retry fits
    raise OSError(f"native TFRecord fixed parse failed ({rc}): {path}")


def parse_file_columns(
    path: str, keys: list[str]
) -> list[dict[str, Any]]:
    """Parses all records of one TFRecord file for the given keys.

    Returns one dict per record with the value forms of
    tfrecord.parse_example: BytesList -> [bytes-like] (all elements
    CONCATENATED into one blob, which fixed-width consumers reshape),
    FloatList -> np.float32 array, Int64List -> np.int64 array; missing
    keys are absent. The values are zero-copy views (memoryview slices,
    np.frombuffer) into PRIVATE buffers (pooled=False), so they stay
    valid after later parses.
    """
    n, buf, offsets, kinds = _parse_raw(path, keys, pooled=False)
    nk = len(keys)
    out: list[dict[str, Any]] = []
    mv = memoryview(buf)
    kinds_l = kinds.tolist()
    offs_l = offsets.tolist()
    frombuffer = np.frombuffer
    for r in range(n):
        row: dict[str, Any] = {}
        base = r * nk
        for k in range(nk):
            cell = base + k
            kind = kinds_l[cell]
            if kind < 0:
                continue
            lo, hi = offs_l[cell], offs_l[cell + 1]
            if kind == 0:
                row[keys[k]] = [mv[lo:hi]]
            elif kind == 1:
                row[keys[k]] = frombuffer(mv[lo:hi], dtype="<f4")
            else:
                row[keys[k]] = frombuffer(mv[lo:hi], dtype="<i8")
        out.append(row)
    return out
