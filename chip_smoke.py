#!/usr/bin/env python3
"""Smoke run of keras_rs_tpu_torch on one CUDA GPU (PyTorch + CUDA only).

Drives the port's main path, the one-device DLRM-DCNv2 training step and
its scoring forward, at the MLPerf widths (examples/ml_perf/configs.py:
26 Criteo features with their multi-hot sizes, dim 128, bottom MLP
(512, 256, 128), 3 DCNv2 layers of projection 512, top MLP
(1024, 1024, 512, 256, 1), Adagrad lr 0.0034, batch 16384, bf16 compute)
with one cut: each vocabulary is capped at 4,000,000 rows. Weights are
random from --seed; batches are synthetic Criteo-shaped ids.

Phases (any failure raises, so the exit code is not 0):
  1. build    the CUDA kernels from keras_rs_tpu_torch/csrc with nvcc;
  2. kernel   each kernel's wrapper against its plain PyTorch version on
              the card, at the slice's shapes, with CUDA-event times;
  3. small    a small f32 model trained 3 steps on the card and on the
              CPU from the same parameters: the losses and tables agree;
  4. train    8 steps on one fixed batch (loss finite and falling), then
              3 steps on fresh batches; the row kernel launches once per
              step per stack;
  5. score    3 fresh request batches under no_grad: finite logits, the
              embedding state unchanged, no kernel launch;
  6. profile  only with --profile: torch.profiler over 3 more steps on
              the fixed batch, device time per step by part and the
              operator table.

Output: progress lines, then the card's name and power limit
(nvidia-smi), then one JSON line {"kernels": [...]}, then last one JSON
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the package beside it, it exits with an error and prints no result.

Usage (from the repository root): python3 chip_smoke.py [--seed N]
[--profile]
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VOCAB_CAP = 4_000_000
BATCH = 16_384
CHECK_ROWS = 6_000_000  # rows of the table the kernel check runs on
FIXED_STEPS = 8
FRESH_STEPS = 3
SCORE_BATCHES = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean milliseconds of `fn()` over `iters` back-to-back runs,
    bracketed by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The MLPerf DLRM-DCNv2 Criteo shapes (examples/ml_perf/configs.py:14-23),
# copied so this script imports nothing of the JAX side.
CRITEO_VOCAB_SIZES = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
CRITEO_MULTI_HOT_SIZES = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]


def slice_config(batch: int = BATCH, vocab_cap: int = VOCAB_CAP):
    from keras_rs_tpu_torch.models.dlrm import DLRMConfig

    vocab = [min(v, vocab_cap) for v in CRITEO_VOCAB_SIZES]
    threshold = 21_000
    large_valence = sum(
        m for v, m in zip(vocab, CRITEO_MULTI_HOT_SIZES) if v >= threshold
    )
    # Worst-case capacities (every id of the batch unique): nothing is
    # dropped and the construction-order forward applies.
    cap = batch * large_valence
    return DLRMConfig(
        vocab_sizes=vocab,
        multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
        embedding_threshold=threshold,
        max_ids_per_partition=cap,
        max_unique_ids_per_partition=cap,
        global_batch_size=batch,
        table_placement="sharded",
    )


def phase_build() -> None:
    from keras_rs_tpu_torch.kernels import loader

    t0 = time.perf_counter()
    built = loader.load("row_ops")
    wall = time.perf_counter() - t0
    log(f"[build] row_ops: nvcc {built.build_seconds:.2f} s, load "
        f"{wall:.2f} s -> {built.path.relative_to(ROOT)}")
    functor = "?"
    for line in built.build_log.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelINS_\d+(\w+?)E",
                      line)
        if m:
            functor = m.group(1)
        elif "registers" in line or "spill" in line:
            log(f"[build]   {functor}: {line.strip()}")


def phase_kernel(unique_slots, sink: int, seed: int) -> dict:
    """B1 against its plain version on a CHECK_ROWS-row table, with the
    slice's N (the unique capacity) and a real batch's n_valid: the live
    prefix maps to sorted distinct random rows, the tail to the sink."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import optimizers
    from keras_rs_tpu_torch.ops import row_ops

    dev = unique_slots.device
    n = unique_slots.shape[0]
    nv = int((unique_slots != sink).sum())
    if not 0 < nv < CHECK_ROWS:
        fail(f"n_valid {nv} outside (0, {CHECK_ROWS})")
    g = torch.Generator(device=dev).manual_seed(seed)
    live = torch.randperm(CHECK_ROWS - 1, generator=g, device=dev)[:nv]
    idx = torch.full((n,), CHECK_ROWS - 1, dtype=torch.int32, device=dev)
    idx[:nv] = live.sort().values.to(torch.int32)
    packed0 = torch.randn((CHECK_ROWS, 2, 128), generator=g, device=dev)
    packed0[:, 1].abs_().add_(0.1)  # accumulators > 0
    grads = torch.randn((n, 128), generator=g, device=dev)
    grads[nv:] = 0.0  # sink padding carries zero gradients
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    step = torch.zeros(1, device=dev)
    opt = optimizers.Adagrad(learning_rate=0.0034)
    args = (idx, grads, step, opt, n_valid)

    got, want = packed0.clone(), packed0.clone()
    row_ops.apply_scatter_row_blocks(got, *args)
    row_ops.apply_scatter_row_blocks_reference(want, *args)
    torch.cuda.synchronize()
    touched = torch.zeros(CHECK_ROWS, dtype=torch.bool, device=dev)
    touched[idx[:nv].long()] = True
    changed = (got != packed0).flatten(1).any(dim=1)
    if bool(changed[~touched].any()):
        fail("kernel wrote rows outside the live prefix")
    if not bool(changed[touched].any()):
        fail("kernel left the live rows unchanged")
    del changed
    err = (got[touched] - want[touched]).abs().max().item()
    # Bound: 4 f32 ulp relative (built with -fmad=false, so every op
    # rounds once in the plain version's order; expected 0).
    torch.testing.assert_close(
        got[touched], want[touched], rtol=4 * 2.0**-23, atol=1e-12
    )
    del want, touched

    # SGD functor (k = 1) on a small table: bit-exact.
    sgd = optimizers.SGD(learning_rate=0.1)
    p1 = torch.randn((4096, 1, 128), generator=g, device=dev)
    p2 = p1.clone()
    sidx = torch.randperm(4096, generator=g, device=dev)[:1000].to(
        torch.int32)
    sg = torch.randn((1000, 128), generator=g, device=dev)
    snv = torch.tensor([700], dtype=torch.int32, device=dev)
    row_ops.apply_scatter_row_blocks(p1, sidx, sg, step, sgd, snv)
    row_ops.apply_scatter_row_blocks_reference(p2, sidx, sg, step, sgd, snv)
    if not torch.equal(p1, p2):
        fail("SGD kernel differs from its plain version")

    # Times at the slice shape, in turns: plain, kernel, kernel, plain.
    iters = 10
    kern = lambda: row_ops.apply_scatter_row_blocks(got, *args)  # noqa
    plain = lambda: row_ops.apply_scatter_row_blocks_reference(  # noqa
        got, *args)
    kern(), plain()  # warm-up
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_time_ms(kern if name == "kernel" else plain,
                                        iters))
    ms, plain_ms = statistics.mean(times["kernel"]), statistics.mean(
        times["plain"])
    moved = nv * (2 * 2 * 128 * 4 + 128 * 4 + 4)
    log(f"[kernel] apply_scatter_row_blocks N={n} n_valid={nv} rows="
        f"{CHECK_ROWS}: max_abs_err {err!r}; kernel {ms!r} ms "
        f"({moved / ms / 1e6:.1f} GB/s of {moved / 1e9:.3f} GB), plain "
        f"{plain_ms!r} ms; runs {times}")
    del got, packed0, grads
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_small_reference() -> None:
    """The port on the card against the port on the CPU (whose plain
    paths the CPU tests hold to the JAX package): a small f32 model,
    identical parameters, 3 steps. Bound 1e-5 (f32; sum order differs)."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import (
        DLRMConfig,
        DLRMDCNv2,
        bce_loss,
    )
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    B = 64
    cfg = DLRMConfig(
        vocab_sizes=[2000, 1500, 50, 30], multi_hot_sizes=[3, 2, 1, 2],
        bottom_mlp=(64, 128), top_mlp=(64, 32, 1), num_dcn_layers=2,
        dcn_projection_dim=32, embedding_threshold=1000,
        max_ids_per_partition=B * 5, max_unique_ids_per_partition=B * 5,
        learning_rate=0.05, global_batch_size=B, table_placement="sharded",
        compute_dtype=None, dense_output_dtype="float32",
    )
    models = {
        dev: DLRMDCNv2(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev,
        )
        for dev in ("cpu", "cuda")
    }
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    losses = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, m in models.items():
            step = make_train_step(m, bce_loss,
                                   DenseAdagrad(m.parameters(), 0.05))
            losses[dev] = [
                float(step(m.preprocess(criteo_like_batch(
                    B, vocab_sizes=cfg.vocab_sizes,
                    multi_hot_sizes=cfg.multi_hot_sizes, seed=s))))
                for s in (0, 1, 0)
            ]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"[small] f32 losses cuda {losses['cuda']} cpu {losses['cpu']}")
    torch.testing.assert_close(
        torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
        rtol=1e-5, atol=1e-5,
    )
    ta = models["cuda"].embedding_layer.get_embedding_tables()
    tb = models["cpu"].embedding_layer.get_embedding_tables()
    for k in tb:
        torch.testing.assert_close(ta[k].cpu(), tb[k], rtol=1e-5, atol=1e-5)


# Parts of the step for the profile: (part, profiler row, time). "total"
# is the device time of the operator row and all it calls, "self" the
# device time of the row alone; a row named "kernel:<name>" is the CUDA
# kernel whose name contains <name>. The parts nest, so they do not add
# up to the total.
PROFILE_PARTS = [
    ("stacked lookup backward", "_StackLookupBackward", "total"),
    ("  row kernel", "kernel:apply_scatter_row_blocks_kernel", "self"),
    ("  segment-sum index_add_", "aten::index_add_", "self"),
    ("small-table EmbedReduce backward", "IndexBackward0", "total"),
    ("stacked lookup forward", "_StackLookup", "total"),
    ("dense matmuls (forward and backward)", "aten::mm", "self"),
    ("dtype casts", "aten::_to_copy", "total"),
]


def phase_profile(step, pre, steps: int = 3) -> None:
    """Device time per training step by part, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(pre)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step(pre)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    avgs = prof.key_averages()
    # Operator rows also carry the device time of the kernels they
    # launch: only the kernel rows are summed for the total.
    kernel_ms = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / steps
    log(f"[profile] {steps} steps: wall {wall_ms!r} ms per step, device "
        f"kernels {kernel_ms!r} ms per step")
    for part, row, time_of in PROFILE_PARTS:
        if row.startswith("kernel:"):
            rows = [e for e in avgs if row[len("kernel:"):] in e.key]
        else:
            rows = [e for e in avgs if e.key == row]
        us = sum(e.self_device_time_total if time_of == "self"
                 else e.device_time_total for e in rows)
        log(f"[profile] {part}: {us / 1e3 / steps!r} ms per step ({row}, "
            f"{time_of})")
    log(avgs.table(sort_by="device_time_total", row_limit=30,
                   max_name_column_width=60))


def state_checksum(packed) -> int:
    """Sum of the state's 32-bit words, in chunks (no full-size copy)."""
    import torch

    words = packed.view(torch.int32).view(packed.shape[0], -1)
    total = torch.zeros((), dtype=torch.int64, device=packed.device)
    for lo in range(0, words.shape[0], 1 << 20):
        total += words[lo : lo + (1 << 20)].sum(dtype=torch.int64)
    return int(total)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and the batches")
    parser.add_argument("--profile", action="store_true",
                        help="also profile 3 training steps by part")
    args = parser.parse_args()

    if not (ROOT / "keras_rs_tpu_torch" / "csrc").is_dir():
        fail(f"keras_rs_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this runs on a GPU only")

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2, bce_loss
    from keras_rs_tpu_torch.ops import row_ops
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    card = nvidia_smi_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_build()

    # --- the slice model and its first batch ------------------------------
    cfg = slice_config()
    t0 = time.perf_counter()
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev,
    )
    torch.cuda.synchronize()
    emb = model.embedding_layer
    stacks = emb.stacks
    shapes = [tuple(emb.stack_state(i)["table"].shape)
              for i in range(len(stacks))]
    log(f"[model] built in {time.perf_counter() - t0:.1f} s: "
        f"{len(model.large_idx)} stacked tables in {len(stacks)} stack(s), "
        f"state {shapes}, {len(model.small_idx)} small tables, "
        f"{sum(p.numel() for p in model.parameters())} dense parameters")

    def batch(seed):
        return criteo_like_batch(
            BATCH, vocab_sizes=cfg.vocab_sizes,
            multi_hot_sizes=cfg.multi_hot_sizes, seed=seed,
        )

    preprocess_s = []

    def preprocess(raw):
        t = time.perf_counter()
        pre = model.preprocess(raw)
        torch.cuda.synchronize()
        preprocess_s.append(time.perf_counter() - t)
        return pre

    fixed = preprocess(batch(args.seed))
    coo = fixed["large_pre"]["sharded"][stacks[0].name]

    kernel = phase_kernel(coo["unique_slots"], stacks[0].sink_slot,
                          args.seed)
    phase_small_reference()

    # --- main path: train, then score -------------------------------------
    opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
    step = make_train_step(model, bce_loss, opt)
    torch.cuda.reset_peak_memory_stats()
    row_ops.apply_scatter_row_blocks.launches = 0

    step_ms, losses = [], []

    def timed_step(pre):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(pre)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))

    for _ in range(FIXED_STEPS):
        timed_step(fixed)
    log(f"[train] fixed batch losses {losses}")
    if not all(map(math.isfinite, losses)):
        fail("non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for s in range(FRESH_STEPS):
        timed_step(preprocess(batch(args.seed + 1 + s)))
    log(f"[train] fresh batch losses {losses[FIXED_STEPS:]}")
    if not all(map(math.isfinite, losses)):
        fail("non-finite loss on fresh batches")
    n_steps = FIXED_STEPS + FRESH_STEPS
    launches = row_ops.apply_scatter_row_blocks.launches
    if launches != n_steps * len(stacks):
        fail(f"row kernel launched {launches} times in {n_steps} steps of "
             f"{len(stacks)} stack(s)")
    steps_done = [float(emb.stack_state(i)["step"])
                  for i in range(len(stacks))]
    if steps_done != [float(n_steps)] * len(stacks):
        fail(f"stack step counters {steps_done}, expected {n_steps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] step ms {step_ms}; median {statistics.median(step_ms)!r} "
        f"ms ({BATCH / statistics.median(step_ms) * 1e3:.0f} examples/s); "
        f"peak device memory {peak_gb:.2f} GB; row kernel launches "
        f"{launches}")

    sums = [state_checksum(emb.stack_state(i)["table"])
            for i in range(len(stacks))]
    score_ms = []
    with torch.no_grad():
        for s in range(SCORE_BATCHES):
            pre = preprocess(batch(args.seed + 100 + s))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = model(pre)
            end.record()
            torch.cuda.synchronize()
            score_ms.append(start.elapsed_time(end))
            if tuple(logits.shape) != (BATCH,):
                fail(f"logits shape {tuple(logits.shape)}")
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite logits")
    if [state_checksum(emb.stack_state(i)["table"])
            for i in range(len(stacks))] != sums:
        fail("scoring changed the embedding state")
    if row_ops.apply_scatter_row_blocks.launches != launches:
        fail("scoring launched the row kernel")
    log(f"[score] {SCORE_BATCHES} batches of {BATCH}: forward ms {score_ms}")
    log(f"[host] preprocessing s per batch {preprocess_s}; median "
        f"{statistics.median(preprocess_s)!r} s")

    if args.profile:
        phase_profile(step, fixed)

    log(card)
    print(json.dumps({"kernels": [{
        "name": "apply_scatter_row_blocks",
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/row_ops.cu",
        "replaces": "keras_rs_tpu/ops/row_ops.py:472",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
