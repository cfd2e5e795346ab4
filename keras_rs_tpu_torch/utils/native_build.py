"""Builds the repository's framework-free C++ engines (`native/*.cc`) with
g++ and loads them with ctypes.

The port's own copy of keras_rs_tpu/utils/native_build.py, used by
`layers/embedding/native.py` (the COO preprocessing engine) and
`data/native_io.py` (the TFRecord reader). It shares the sources under
`native/` with the JAX package but never writes there: each library goes
to `build/keras_rs_tpu_torch/<name>-<hash>.so` at the repository root (a
directory git ignores), where the hash covers the source and the flags.
An edited source is therefore rebuilt at its next first use, and an
unchanged one is loaded as built. A build goes to a temporary file that
replaces the target in one step, so processes that build at the same time
never load a half-written library.

`load_shared_lib` returns None when the library cannot be provided (no
g++, no source, a failed build or load); the caller decides whether that
is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "keras_rs_tpu_torch"
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str) -> Path | None:
    """Where `native/<name>.cc` builds to (None without the source)."""
    src = NATIVE_DIR / f"{name}.cc"
    if not src.exists():
        return None
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_shared_lib(name: str) -> Path | None:
    """g++ `native/<name>.cc` into its build path, unless built already;
    the path, or None when the source or the toolchain is missing or the
    build fails."""
    out = library_path(name)
    if out is None:
        return None
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=f".{name}-",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", tmp, str(NATIVE_DIR / f"{name}.cc")],
            check=True, capture_output=True, timeout=120,
        )
    except (subprocess.SubprocessError, OSError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def load_shared_lib(name: str) -> ctypes.CDLL | None:
    """Builds (if needed) and loads `native/<name>.cc`; None if it cannot
    be provided."""
    path = build_shared_lib(name)
    if path is None:
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None
