"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/keras_rs_tpu_torch/<name>-<hash>.so` at the repository root
(a directory git ignores). The hash covers the source and the flags, so
an edited source is rebuilt at its next first use and an unchanged one
is loaded as built. Nothing is compiled when a module is imported: the
first call of a kernel's wrapper on a CUDA tensor builds it.

Flags: sm_90a (Hopper) and -O3 for every source. row_ops.cu adds
-fmad=false, so that its kernel rounds each multiply and add separately,
in the order of its plain PyTorch version (bit-exact). flash_attention.cu
keeps FMA contraction on: attention sums in another order than its plain
version in any case, and is held to a tolerance.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "keras_rs_tpu_torch"
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
#: Flags of one source on top of NVCC_FLAGS.
SOURCE_FLAGS = {"row_ops": ("-fmad=false",)}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of keras_rs_tpu_torch are built at first use."
        )
    return nvcc


class BuiltLibrary:
    """A loaded kernel library with how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        #: Wall time of the nvcc run, 0.0 when the library was already
        #: built for this source hash.
        self.build_seconds = build_seconds
        #: nvcc's output (ptxas register and spill report), "" when not
        #: built in this process.
        self.build_log = build_log


@functools.cache
def load(name: str) -> BuiltLibrary:
    """Builds (if needed) and loads `csrc/<name>.cu`."""
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    build_seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            suffix=".so", prefix=f".{name}-", dir=BUILD_DIR
        )
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return BuiltLibrary(ctypes.CDLL(str(out)), out, build_seconds, log)
