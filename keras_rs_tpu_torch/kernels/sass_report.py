"""Builds the package's CUDA sources and reports, per kernel, what the
compiler made of it: registers, stack and local memory (cuobjdump
-res-usage; local memory or stack above 0 means spills) and counts of
the SASS instructions that show how its products and copies run.

    python3 keras_rs_tpu_torch/kernels/sass_report.py [NAME_FILTER ...]

For every kernel whose readable name contains one of the filters (all
kernels without one): `HMMA.*` (tensor-core MMAs, by shape and type),
`LDSM` (ldmatrix), `LDGSTS` (cp.async), `FFMA` (f32 fused multiply-add on
the CUDA cores), `LDG`/`STG` (plain global loads and stores). Needs nvcc
and cuobjdump (CUDA toolkit under /usr/local/cuda or on PATH).
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from keras_rs_tpu_torch.kernels import loader  # noqa: E402

SOURCES = ("flash_attention", "row_ops")


def readable(mangled: str) -> str:
    m = re.search(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
        mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}, " + (
            "f32>" if m.group(3) == "f" else "bf16>")
    m = re.search(r"(scatter_rows_kernel|apply_scatter_row_blocks_kernel)"
                  r"(?:INS_\d+(\w+?)E)?", mangled)
    if m:
        return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
    return mangled


def _cuobjdump(flag: str, path: Path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(path)], capture_output=True,
                          text=True, check=True).stdout


def resource_usage(path: Path) -> dict[str, str]:
    """REG, STACK and LOCAL per kernel."""
    out, name = {}, None
    for line in _cuobjdump("-res-usage", path).splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = readable(m.group(1))
        elif name and "REG:" in line:
            out[name] = " ".join(
                re.findall(r"(?:REG|STACK|LOCAL):\d+", line))
            name = None
    return out


def sass_counts(path: Path) -> dict[str, collections.Counter]:
    text = _cuobjdump("-sass", path)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = readable(m.group(1))
            counts[name] = collections.Counter()
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            for key in ("HMMA", "LDSM", "LDGSTS", "FFMA", "LDG", "STG"):
                if op == key or op.startswith(key + "."):
                    counts[name][op if key == "HMMA" else key] += 1
    return counts


def main() -> int:
    filters = sys.argv[1:]
    for src in SOURCES:
        lib = loader.load(src)
        regs = resource_usage(lib.path)
        print(f"== {src}: nvcc {lib.build_seconds:.1f} s (0: built "
              f"before), {len(regs)} kernels", flush=True)
        for name, counts in sorted(sass_counts(lib.path).items()):
            if filters and not any(f in name for f in filters):
                continue
            print(f"{name}: {regs.get(name, '?')}; SASS "
                  f"{dict(sorted(counts.items()))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
