"""Builds csrc/flash_attention.cu once per set of extra nvcc flags and
times the flash kernels of each build in turns on one card.

    python3 keras_rs_tpu_torch/kernels/flash_variants.py \
        base= fastmath=-use_fast_math "wide=-DSOME_SWITCH=8 -DOTHER"

Each argument is `name=flags`. A developer who wants to know what one
design choice costs puts it behind a preprocessor switch in the source,
lists one variant per setting here, reads the times and removes the
switch again; the loader's own flags (kernels/loader.py) come first in
every build. The builds run in parallel, then every variant is timed
twice, round-robin, with flash_compare.py's inputs and timing
(CUDA-event mean of 20 launches after a warm-up) at (a) B 128, T 1024,
H 1, hd 50, f32 and (c) B 8, T 4096, H 4, hd 64, bf16: forward (B5), dQ
(B6) and dK/dV (B7). In the first round each variant's O and dQ at (a)
are compared with the plain versions on 16 batch rows (max_abs_err_O,
max_abs_err_dQ), so a switch that breaks the numbers shows.

Prints the card's name and power limit, then per variant its registers
for the instances those shapes run and one JSON line of milliseconds per
round.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import re
import shlex
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SHAPES = {"a": (128, 1024, 1, 50, "float32"),
          "c": (8, 4096, 4, 64, "bfloat16")}


def build(variant: tuple[str, list[str]]):
    from keras_rs_tpu_torch.kernels import loader

    name, extra = variant
    out = loader.BUILD_DIR / f"variant-{name}.so"
    loader.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = loader.NVCC_FLAGS + loader.SOURCE_FLAGS["flash_attention"]
    proc = subprocess.run(
        [loader._nvcc(), *flags, *extra, "-o", str(out),
         str(loader.CSRC_DIR / "flash_attention.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    # Registers of the instances the two shapes run (HDP 56 f32, 64 bf16).
    registers, entry = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(56Ef|64E13)",
                      line)
        if "Compiling entry" in line:
            entry = f"{m.group(1)}<{m.group(2)[:2]}>" if m else None
        elif entry and "registers" in line:
            registers[entry] = int(
                re.search(r"Used (\d+) registers", line).group(1))
        elif entry and "bytes spill" in line and (
                "0 bytes spill stores" not in line):
            registers[entry + " spills"] = line.strip()
    return name, out, registers


def main() -> int:
    import torch

    from keras_rs_tpu_torch.kernels import flash_compare
    from keras_rs_tpu_torch.ops import flash_attention as fa

    variants = []
    for arg in sys.argv[1:]:
        name, _, flags = arg.partition("=")
        variants.append((name, shlex.split(flags)))
    if not variants:
        print(__doc__)
        return 2
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)

    dev = torch.device("cuda", 0)
    data = {label: flash_compare.make_inputs(*shape)
            for label, shape in SHAPES.items()}

    for rnd in range(2):
        for name, path, registers in built:
            lib = ctypes.CDLL(str(path))

            def kernel_fn(entry, lib=lib):
                fn = getattr(lib, entry)
                fn.argtypes = (
                    [ctypes.c_void_p] * fa._N_POINTERS[entry]
                    + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                return fn

            fa._kernel_fn = kernel_fn  # the wrappers now call this build
            ms = {}
            for label, (q, k, v, dout, mask) in data.items():
                B, T, _, hd = q.shape
                bias = fa.key_bias(mask, B, T, dev)
                scale = 1.0 / math.sqrt(hd)
                out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, True)
                delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
                args = (q, k, v, bias, dout, lse, delta.contiguous(), scale,
                        True)
                if rnd == 0 and label == "a":
                    rows = fa.rows_with_visible_key(mask, B, T, True,
                                                    dev)[:16]
                    want, _ = fa.flash_attention_fwd_reference(
                        q[:16], k[:16], v[:16], bias[:16], scale, True)
                    ms["a:max_abs_err_O"] = float(
                        (out[:16][rows] - want[rows]).abs().max())
                    small = tuple(x[:16] for x in args[:7]) + args[7:]
                    got = fa.flash_attention_bwd_dq(*small)
                    want = fa.flash_attention_bwd_dq_reference(*small)
                    ms["a:max_abs_err_dQ"] = float(
                        (got[rows] - want[rows]).abs().max())
                ms[f"{label}:fwd"] = flash_compare.time_ms(
                    lambda: fa.flash_attention_fwd(q, k, v, bias, scale,
                                                   True))
                ms[f"{label}:dq"] = flash_compare.time_ms(
                    lambda: fa.flash_attention_bwd_dq(*args))
                ms[f"{label}:dkv"] = flash_compare.time_ms(
                    lambda: fa.flash_attention_bwd_dkv(*args))
            if rnd == 0:
                print(name, "registers", registers, flush=True)
            print(json.dumps({"variant": name, "round": rnd, "ms": ms}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
