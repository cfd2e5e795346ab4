"""Times the attention layer's two paths against each other on one card,
to place `FLASH_MIN_T` (layers/attention.py).

    python3 keras_rs_tpu_torch/kernels/flash_crossover.py [T ...]

At the SASRec widths (batch 128, hidden 50, 1 head, f32; a quarter of the
rows left-padded to a random >= 16 keys, seed 0) and each T (default 64,
128, 200, 256, 512), one `MultiHeadSelfAttention` runs forward alone and
forward + backward (`backward` of a fixed output gradient) on its einsum
path (`use_flash=False`) and on the kernels (`use_flash=True`: B5, then
B6 and B7). The two paths share the projections, so the difference is
the attention itself. Timed in turns (einsum, kernels, kernels, einsum),
CUDA-event means over 20 calls after a warm-up, in milliseconds, TF32
off. Prints the card's name and power limit, one JSON line per T, and
the smallest T from which the kernels are no slower on forward +
backward.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

B, DIM = 128, 50
LENGTHS = (64, 128, 200, 256, 512)


def main() -> int:
    import torch

    from keras_rs_tpu_torch.kernels import flash_compare
    from keras_rs_tpu_torch.layers.attention import MultiHeadSelfAttention
    from keras_rs_tpu_torch.utils.timing import card_line

    lengths = [int(a) for a in sys.argv[1:]] or list(LENGTHS)
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    crossover = None
    for T in lengths:
        g = torch.Generator(device=dev).manual_seed(0)
        layer = MultiHeadSelfAttention(
            DIM, 1, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        x = torch.randn((B, T, DIM), generator=g, device=dev,
                        requires_grad=True)
        dy = torch.randn((B, T, DIM), generator=g, device=dev)
        mask = torch.ones((B, T), device=dev)
        cut = torch.randperm(B, generator=g, device=dev)[: B // 4]
        keep = torch.randint(16, T + 1, (len(cut),), generator=g, device=dev)
        mask[cut] = (torch.arange(T, device=dev)[None, :]
                     >= (T - keep)[:, None]).float()

        def forward(flash):
            layer.use_flash = flash
            with torch.no_grad():
                layer(x, padding_mask=mask)

        def train(flash):
            layer.use_flash = flash
            layer(x, padding_mask=mask).backward(dy)

        row = {"T": T}
        for what, fn in (("fwd", forward), ("fwd_bwd", train)):
            times = {False: [], True: []}
            for flash in (False, True, True, False):
                times[flash].append(flash_compare.time_ms(
                    lambda: fn(flash)))
            row[f"einsum_{what}_ms"] = sum(times[False]) / 2
            row[f"kernels_{what}_ms"] = sum(times[True]) / 2
        print(json.dumps(row), flush=True)
        if crossover is None and (
                row["kernels_fwd_bwd_ms"] <= row["einsum_fwd_bwd_ms"]):
            crossover = T
        elif row["kernels_fwd_bwd_ms"] > row["einsum_fwd_bwd_ms"]:
            crossover = None
        del layer, x, dy, mask
        torch.cuda.empty_cache()
    print(f"kernels no slower on forward + backward from T = {crossover} "
          "(of the lengths timed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
