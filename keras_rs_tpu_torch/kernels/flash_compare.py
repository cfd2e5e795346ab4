"""Times the flash attention kernels of two checkouts on one card.

    python3 keras_rs_tpu_torch/kernels/flash_compare.py PARENT_TREE NEW_TREE

Each tree is a directory that holds `keras_rs_tpu_torch/` (for an earlier
commit: `git archive <commit> | tar -x -C <dir>`). The trees are timed in
the order parent, new, new, parent, each in a process of its own (it
builds that tree's csrc/flash_attention.cu first), so that both versions
meet the same card, clocks and power limit. Shapes: (a) the SASRec
training launch, B 128, T 1024, H 1, hd 50, f32; (c) bf16, B 8, T 4096,
H 4, hd 64; (d) the SASRec serving launch, B 1024, T 1024, H 1, hd 50,
f32, forward only. A quarter of the batch rows are left-padded. Times are
CUDA-event means over 20 launches after a warm-up, in milliseconds.

Prints one JSON line per run and a closing table; the first line is the
card's name and power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

SHAPES = [  # label, B, T, H, hd, dtype, kernels timed
    ("a", 128, 1024, 1, 50, "float32", ("fwd", "dq", "dkv")),
    ("c", 8, 4096, 4, 64, "bfloat16", ("fwd", "dq", "dkv")),
    ("d", 1024, 1024, 1, 50, "float32", ("fwd",)),
]
ITERS = 20


def make_inputs(B: int, T: int, H: int, hd: int, dtype_name: str):
    """q, k, v, dO [B, T, H, hd] and a key mask [B, T] on the card, from
    seed 0; a quarter of the batch rows keep a random >= 16 last keys."""
    import torch

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device=dev)
                     .to(getattr(torch, dtype_name)) for _ in range(4))
    mask = torch.ones((B, T), device=dev)
    cut = torch.randperm(B, generator=g, device=dev)[: B // 4]
    lengths = torch.randint(16, T + 1, (len(cut),), generator=g, device=dev)
    mask[cut] = (torch.arange(T, device=dev)[None, :]
                 >= (T - lengths)[:, None]).float()
    return q, k, v, dout, mask


def time_ms(fn) -> float:
    """CUDA-event mean of ITERS launches of `fn` after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def time_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    from keras_rs_tpu_torch.ops import flash_attention as fa

    times = {}
    for label, B, T, H, hd, dtype_name, kernels in SHAPES:
        q, k, v, dout, mask = make_inputs(B, T, H, hd, dtype_name)
        bias = fa.key_bias(mask, B, T, q.device)
        scale = 1.0 / math.sqrt(hd)
        out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, bias, dout, lse, delta.contiguous(), scale, True)
        calls = {
            "fwd": lambda: fa.flash_attention_fwd(q, k, v, bias, scale, True),
            "dq": lambda: fa.flash_attention_bwd_dq(*args),
            "dkv": lambda: fa.flash_attention_bwd_dkv(*args),
        }
        for name in kernels:
            times[f"{label}:{name}"] = time_ms(calls[name])
    return times


def compare(script: str, parent: str, new: str) -> int:
    """Runs `script --time TREE` for parent, new, new, parent, one process
    each; prints the card, one JSON line per run and a closing table."""
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
    runs = []
    for which, tree in (("parent", parent), ("new", new), ("new", new),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, script, "--time", tree],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, sep="\n")
            return 1
        times = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append((which, times))
        print(json.dumps({"tree": which, "ms": times}), flush=True)
    print(f"{'kernel':10} {'parent ms':>24} {'new ms':>24} {'ratio':>7}")
    for key in runs[0][1]:
        old = [t[key] for w, t in runs if w == "parent"]
        cur = [t[key] for w, t in runs if w == "new"]
        print(f"{key:10} {old[0]:11.4f} {old[1]:11.4f}  "
              f"{cur[0]:11.4f} {cur[1]:11.4f} "
              f"{sum(old) / sum(cur):7.2f}")
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(time_tree(sys.argv[2])))
        return 0
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    return compare(__file__, *sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
