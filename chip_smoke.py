#!/usr/bin/env python3
"""Smoke run of keras_rs_tpu_torch on one CUDA GPU (PyTorch + CUDA only).

Drives the port's two main paths through the entry points a user calls,
each at the full width of a model the repo supports, with random weights
from --seed:

  * DLRM-DCNv2 training step and scoring forward at the MLPerf widths
    (examples/ml_perf/configs.py: 26 Criteo features with their multi-hot
    sizes, dim 128, bottom MLP (512, 256, 128), 3 DCNv2 layers of
    projection 512, top MLP (1024, 1024, 512, 256, 1), Adagrad lr 0.0034,
    batch 16384, bf16 compute), each vocabulary capped at 4,000,000 rows;
    synthetic Criteo-shaped ids. Kernel B1 (csrc/row_ops.cu).
  * SASRec at the published ML-1M widths (models/sasrec.py defaults: 2
    blocks, 1 head, hidden 50, MLP 50, 3,706 items; Adam lr 0.005, batch
    128, f32) with the long-history context T = 1024, trained through
    Trainer + sasrec_loss and served by the last state + top-10
    BruteForceRetrieval. Markov sessions (branching 12, noise 0.2); a
    quarter of each batch cut to a random history of >= 16 items and
    padded with id 0. Kernels B5-B7 (csrc/flash_attention.cu).

Phases (any failure raises, so the exit code is not 0):
  1. build         all CUDA sources of keras_rs_tpu_torch/csrc, one nvcc
                   each, started together; nvcc time and ptxas registers;
  2. dlrm kernel   B1 against its plain version at the slice's shapes;
  3. dlrm small    a small f32 DLRM, 3 steps on the card and on the CPU;
  4. dlrm train    8 steps on one fixed batch (loss falls), then 3 fresh
                   batches; B1 launches once per step per stack;
  5. dlrm score    3 fresh request batches: finite logits, state
                   unchanged, no B1 launch;
  6. flash kernel  B5, B6, B7 each against its plain version at (a) the
                   slice (B 128, H 1, T 1024, hd 50, f32), (b) the
                   published T 200, (c) bf16 B 8, H 4, T 4096, hd 64,
                   with CUDA-event times, the bound, and
                   scaled_dot_product_attention as a yardstick only;
  7. sasrec small  a small f32 SASRec (T 512) 3 Adam steps on the card
                   (kernels) and on the CPU (einsum path): losses and
                   parameters agree;
  8. sasrec train  8 steps on one fixed batch (loss falls), then 3 fresh
                   batches; B5, B6, B7 launch once per block per step;
  9. sasrec serve  3 batches of 1024 users under no_grad: user states,
                   top-10 ids in [0, 3706], parameters unchanged, B5 only;
 10. profile       only with --profile: torch.profiler over 3 more steps
                   of each model, device time per step by part.

The launch counts in the kernels line are those of the main paths alone:
every count is set to 0 just before a path's train-and-serve run and read
just after it.

Output: progress lines, then the card's name and power limit
(nvidia-smi), then one JSON line {"kernels": [...]}, then last one JSON
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the package beside it, it exits with an error and prints no result.

Usage (from the repository root): python3 chip_smoke.py [--seed N]
[--profile]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VOCAB_CAP = 4_000_000
BATCH = 16_384
CHECK_ROWS = 6_000_000  # rows of the table the kernel check runs on
FIXED_STEPS = 8
FRESH_STEPS = 3
SCORE_BATCHES = 3

# SASRec slice: the published ML-1M widths (models/sasrec.py defaults),
# the long-history context, examples/sas_rec.py's optimizer and data.
SAS_ITEMS = 3706
SAS_T = 1024
SAS_BATCH = 128
SAS_LR = 0.005
SAS_SERVE_USERS = 1024
SAS_TOP_K = 10
# Flash kernel check shapes: (label, B, T, H, hd, dtype name).
FLASH_SHAPES = [
    ("a", SAS_BATCH, SAS_T, 1, 50, "float32"),
    ("b", SAS_BATCH, 200, 1, 50, "float32"),
    ("c", 8, 4096, 4, 64, "bfloat16"),
]
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
FLASH_REPLACES = {
    "flash_attention_fwd": "keras_rs_tpu/ops/flash_attention.py:48",
    "flash_attention_bwd_dq": "keras_rs_tpu/ops/flash_attention.py:85",
    "flash_attention_bwd_dkv": "keras_rs_tpu/ops/flash_attention.py:116",
}
# H100 SXM published peaks: HBM bytes/s, and FLOP/s by
# input type (f32 on the CUDA cores, bf16 on the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


def _entry_name(mangled: str) -> str:
    """A readable name for a ptxas entry: the row kernel's functor, or a
    flash kernel with its head-dim tile and input type."""
    m = re.search(r"kernelINS_\d+(\w+?)E", mangled)
    if m:
        return m.group(1)
    m = re.search(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
        mangled)
    if m:
        dtype = "f32" if m.group(3) == "f" else "bf16"
        return f"{m.group(1)}<{m.group(2)}, {dtype}>"
    return mangled


def phase_build() -> None:
    """Builds every csrc source at once (one nvcc process each)."""
    from keras_rs_tpu_torch.kernels import loader

    names = sorted(p.stem for p in loader.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(loader.load, names)))
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.2f} s "
        "wall")
    for name, lib in built.items():
        log(f"[build] {name}: nvcc {lib.build_seconds:.2f} s -> "
            f"{lib.path.relative_to(ROOT)}")
        entry = "?"
        for line in lib.build_log.splitlines():
            m = re.search(r"Compiling entry function '(.*?)'", line)
            if m:
                entry = _entry_name(m.group(1))
            elif "registers" in line or "spill" in line:
                log(f"[build]   {entry}: {line.strip()}")


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
    # Bytes: each live block read and written, its gradient row and
    # index read once.
    moved = nv * (2 * 2 * 128 * 4 + 128 * 4 + 4)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] apply_scatter_row_blocks N={n} n_valid={nv} rows="
        f"{CHECK_ROWS}: max_abs_err {err!r}; kernel {ms!r} ms "
        f"({moved / ms / 1e6:.1f} GB/s of {moved / 1e9:.3f} GB), plain "
        f"{plain_ms!r} ms, bound {bound_ms!r} ms (bytes); runs {times}")
    del got, packed0, grads
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


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


# Parts of a step for the profile: (part, profiler row, time). "total"
# is the device time of the operator row and all it calls, "self" the
# device time of the row alone; a row named "kernel:<name>" is the CUDA
# kernel whose name contains <name>. The parts nest, so they do not add
# up to the total.
DLRM_PROFILE_PARTS = [
    ("stacked lookup backward", "_StackLookupBackward", "total"),
    ("  row kernel", "kernel:apply_scatter_row_blocks_kernel", "self"),
    ("  segment-sum index_add_", "aten::index_add_", "self"),
    ("small-table EmbedReduce backward", "IndexBackward0", "total"),
    ("stacked lookup forward", "_StackLookup", "total"),
    ("dense matmuls (forward and backward)", "aten::mm", "self"),
    ("dtype casts", "aten::_to_copy", "total"),
]
SASREC_PROFILE_PARTS = [
    ("B5 flash forward kernel", "kernel:flash_fwd_kernel", "self"),
    ("B6 flash dQ kernel", "kernel:flash_bwd_dq_kernel", "self"),
    ("B7 flash dK/dV kernel", "kernel:flash_bwd_dkv_kernel", "self"),
    ("matmuls", "aten::mm", "self"),
    ("elementwise multiplies", "aten::mul", "self"),
    ("item-embedding backward", "EmbeddingBackward0", "total"),
]


def phase_profile(label: str, step, batch, parts, steps: int = 3) -> None:
    """Device time per training step by part, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    avgs = prof.key_averages()
    # Operator rows also carry the device time of the kernels they
    # launch: only the kernel rows are summed for the total.
    kernel_ms = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / steps
    log(f"[profile] {label}, {steps} steps: wall {wall_ms!r} ms per step, "
        f"device kernels {kernel_ms!r} ms per step")
    for part, row, time_of in parts:
        if row.startswith("kernel:"):
            rows = [e for e in avgs if row[len("kernel:"):] in e.key]
        else:
            rows = [e for e in avgs if e.key == row]
        us = sum(e.self_device_time_total if time_of == "self"
                 else e.device_time_total for e in rows)
        log(f"[profile] {label} {part}: {us / 1e3 / steps!r} ms per step "
            f"({row}, {time_of})")
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


def reset_launch_counts() -> None:
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops

    row_ops.apply_scatter_row_blocks.launches = 0
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def launch_counts() -> dict[str, int]:
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops

    counts = {"apply_scatter_row_blocks":
              row_ops.apply_scatter_row_blocks.launches}
    counts.update({name: getattr(fa, name).launches
                   for name in FLASH_KERNELS})
    return counts


def run_dlrm(seed: int, profile: bool) -> dict:
    """The DLRM phases; returns B1's kernel entry."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2, bce_loss
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    cfg = slice_config()
    t0 = time.perf_counter()
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
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

    def batch(s):
        return criteo_like_batch(
            BATCH, vocab_sizes=cfg.vocab_sizes,
            multi_hot_sizes=cfg.multi_hot_sizes, seed=s,
        )

    preprocess_s = []

    def preprocess(raw):
        t = time.perf_counter()
        pre = model.preprocess(raw)
        torch.cuda.synchronize()
        preprocess_s.append(time.perf_counter() - t)
        return pre

    fixed = preprocess(batch(seed))
    coo = fixed["large_pre"]["sharded"][stacks[0].name]

    kernel = phase_kernel(coo["unique_slots"], stacks[0].sink_slot, seed)
    phase_small_reference()

    # --- main path: train, then score -------------------------------------
    opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
    step = make_train_step(model, bce_loss, opt)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

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
        timed_step(preprocess(batch(seed + 1 + s)))
    log(f"[train] fresh batch losses {losses[FIXED_STEPS:]}")
    if not all(map(math.isfinite, losses)):
        fail("non-finite loss on fresh batches")
    n_steps = FIXED_STEPS + FRESH_STEPS
    launches = launch_counts()["apply_scatter_row_blocks"]
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
            pre = preprocess(batch(seed + 100 + s))
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
    counts = launch_counts()
    if [state_checksum(emb.stack_state(i)["table"])
            for i in range(len(stacks))] != sums:
        fail("scoring changed the embedding state")
    if counts["apply_scatter_row_blocks"] != launches:
        fail("scoring launched the row kernel")
    if any(counts[name] for name in FLASH_KERNELS):
        fail(f"the DLRM path launched a flash kernel: {counts}")
    log(f"[score] {SCORE_BATCHES} batches of {BATCH}: forward ms {score_ms}")
    log(f"[host] preprocessing s per batch {preprocess_s}; median "
        f"{statistics.median(preprocess_s)!r} s")

    if profile:
        phase_profile("dlrm", step, fixed, DLRM_PROFILE_PARTS)
    del model, emb, opt, step, fixed, coo
    torch.cuda.empty_cache()
    return {
        "name": "apply_scatter_row_blocks",
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/row_ops.cu",
        "replaces": "keras_rs_tpu/ops/row_ops.py:472",
        "launches": launches,
        **kernel,
    }


# --- SASRec -------------------------------------------------------------


def sasrec_batch(batch: int, T: int, seed: int,
                 pad: str = "left") -> dict[str, np.ndarray]:
    """Markov sessions over the ML-1M item count, as examples/sas_rec.py
    builds them (branching 12, noise 0.2, uniform negatives away from the
    positive). A quarter of the rows keep a random >= 16 items of their
    history, padded with id 0 on the left (training) or on the right
    (serving: `SASRec.__call__` reads position sum(ids != 0) - 1)."""
    from keras_rs_tpu_torch.data.synthetic import markov_sessions

    seq = markov_sessions(num_items=SAS_ITEMS, num_sessions=batch,
                          length=T, branching=12, noise=0.2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    hist, pos = seq[:, :T].copy(), seq[:, 1:].copy()
    neg = rng.integers(1, SAS_ITEMS + 1, size=pos.shape).astype(np.int32)
    neg = np.where(neg == pos, pos % SAS_ITEMS + 1, neg).astype(np.int32)
    cut = rng.permutation(batch)[: batch // 4]
    for row, n in zip(cut, rng.integers(16, T + 1, size=len(cut))):
        for a in (hist, pos, neg):
            if pad == "left":
                a[row, : T - n] = 0
            else:
                a[row, n:] = 0
    return {"item_history": hist, "positive_sequence": pos,
            "negative_sequence": neg}


def flash_bound(name: str, B: int, T: int, H: int, hd: int, dtype: str,
                elem: int, mask) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one flash kernel on these
    inputs: products over the (query, key) pairs this data needs (causal,
    real keys only), each input read once and each output written once."""
    import torch

    pairs = H * int(mask.to(torch.int64).cumsum(dim=1).sum())
    n = B * T * H * hd
    stats = 4 * B * H * T  # one f32 lse or delta
    bias = 4 * B * T
    flops, moved = {
        # S = QK^T, O = PV
        "flash_attention_fwd": (4 * hd * pairs,
                                4 * n * elem + stats + bias),
        # S, dP = dO V^T, dQ = dS K
        "flash_attention_bwd_dq": (6 * hd * pairs,
                                   5 * n * elem + 2 * stats + bias),
        # S, dV = P^T dO, dP, dK = dS^T Q (dK, dV in f32)
        "flash_attention_bwd_dkv": (8 * hd * pairs,
                                    4 * n * elem + 8 * n + 2 * stats + bias),
    }[name]
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_flash_kernel(label: str, B: int, T: int, H: int, hd: int,
                       dtype_name: str, seed: int) -> dict:
    """B5, B6 and B7 against their plain versions on one shape, with
    times. Compared on the query rows that see a real key (the kernel
    contract); dO is 0 on the others, as in SASRec."""
    import torch
    import torch.nn.functional as F

    from keras_rs_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    mask = torch.ones((B, T), device=dev)
    cut = torch.randperm(B, generator=g, device=dev)[: B // 4]
    lengths = torch.randint(16, T + 1, (len(cut),), generator=g, device=dev)
    mask[cut] = (torch.arange(T, device=dev)[None, :]
                 >= (T - lengths)[:, None]).float()
    bias = fa.key_bias(mask, B, T, dev)
    scale = 1.0 / math.sqrt(hd)
    rows = fa.rows_with_visible_key(mask, B, T, True, dev)
    f32 = dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=3e-2, atol=3e-2)
    gtol = dict(rtol=1e-4, atol=2e-5) if f32 else tol

    def check(what, got, want, bound):
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"({label}) {what}: non-finite values")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **bound,
                                   msg=lambda m: f"({label}) {what}: {m}")
        log(f"[flash {label}] {what}: max |plain| "
            f"{want.float().abs().max().item()!r}, max_abs_err {err!r}")
        return err

    out, lse = fa.flash_attention_fwd(q, k, v, bias, scale, True)
    want_out, want_lse = fa.flash_attention_fwd_reference(
        q, k, v, bias, scale, True)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out.float()).all())
            and bool(torch.isfinite(lse).all())):
        fail(f"({label}) forward: non-finite values on uncovered rows")
    errs = {"flash_attention_fwd": max(
        check("O", out[rows], want_out[rows], tol),
        check("lse", lse.transpose(1, 2)[rows],
              want_lse.transpose(1, 2)[rows], dict(rtol=1e-5, atol=1e-5)),
    )}
    dout = dout * rows[:, :, None, None].to(dtype)
    delta = (dout.float() * want_out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, bias, dout, want_lse, delta.contiguous(), scale, True)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    want_dq = fa.flash_attention_bwd_dq_reference(*args)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    errs["flash_attention_bwd_dq"] = check("dQ", dq[rows], want_dq[rows],
                                           gtol)
    errs["flash_attention_bwd_dkv"] = max(check("dK", dk, want_dk, gtol),
                                          check("dV", dv, want_dv, gtol))
    del out, lse, want_out, dq, dk, dv, want_dq, want_dk, want_dv

    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, bias, scale, True),
            lambda: fa.flash_attention_fwd_reference(q, k, v, bias, scale,
                                                     True)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*args),
            lambda: fa.flash_attention_bwd_dq_reference(*args)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*args),
            lambda: fa.flash_attention_bwd_dkv_reference(*args)),
    }
    result = {}
    for name, (kern, plain) in calls.items():
        kern(), plain()  # warm-up
        times = {"plain": [], "kernel": []}
        for turn in ("plain", "kernel", "kernel", "plain"):
            times[turn].append(cuda_time_ms(
                kern if turn == "kernel" else plain,
                10 if turn == "kernel" else 3))
        ms = statistics.mean(times["kernel"])
        plain_ms = statistics.mean(times["plain"])
        bound_ms, bound_by = flash_bound(name, B, T, H, hd, dtype_name,
                                         q.element_size(), mask)
        result[name] = {"max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None}
        log(f"[flash {label}] {name} B={B} T={T} H={H} hd={hd} "
            f"{dtype_name}: max_abs_err {errs[name]!r}; kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}, "
            f"{bound_ms / ms:.1%} of it); runs {times}")
    torch.cuda.empty_cache()

    # Yardstick only (the port never calls it): PyTorch's fused attention
    # with the same boolean mask, forward and forward + backward.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                       for x in (q, k, v, dout))
    attn_mask = (torch.ones((T, T), dtype=torch.bool, device=dev).tril()
                 [None, None] & (mask[:, None, None, :] > 0))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              attn_mask=attn_mask,
                                              scale=scale)

    leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(
            *leaves, attn_mask=attn_mask, scale=scale).backward(dot)

    sdpa(), sdpa_fwd_bwd()
    sdpa_ms = cuda_time_ms(sdpa, 10)
    sdpa_fb_ms = cuda_time_ms(sdpa_fwd_bwd, 5)
    result["flash_attention_fwd"]["library_ms"] = sdpa_ms
    result["sdpa_fwd_bwd_ms"] = sdpa_fb_ms
    log(f"[flash {label}] yardstick scaled_dot_product_attention with the "
        f"boolean mask: forward {sdpa_ms!r} ms, forward+backward "
        f"{sdpa_fb_ms!r} ms (kernels: forward "
        f"{result['flash_attention_fwd']['ms']!r} ms, fwd + dQ + dK/dV "
        f"{sum(result[n]['ms'] for n in FLASH_KERNELS)!r} ms)")
    del qt, kt, vt, dot, attn_mask, leaves
    torch.cuda.empty_cache()
    return result


def sasrec_model(seed: int, **overrides):
    import torch

    from keras_rs_tpu_torch.models.sasrec import SASRec

    dev = overrides.pop("device", "cuda")
    widths = dict(num_layers=2, num_heads=1, hidden_dim=50, mlp_dim=50,
                  max_sequence_length=SAS_T)
    widths.update(overrides)
    return SASRec(SAS_ITEMS, **widths,
                  generator=torch.Generator(device=dev).manual_seed(seed),
                  device=dev)


def phase_sasrec_small() -> None:
    """The port on the card (flash kernels: T = FLASH_MIN_T) against the
    port on the CPU (einsum path, held to the JAX package by the CPU
    tests): a small f32 SASRec, identical parameters, 3 Adam steps on
    left-padded batches. Bound 1e-5 (f32; sums in another order). Adam's
    eps is 1e-5 here (1e-8 in the slice): with 1e-8 a parameter whose
    gradient cancels to ~1e-8 moves by up to lr on sum-order noise."""
    import torch

    from keras_rs_tpu_torch.models.sasrec import sasrec_loss
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.training.train_state import DenseAdam
    from keras_rs_tpu_torch.training.trainer import Trainer

    T, B = 512, 4
    widths = dict(num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=32,
                  max_sequence_length=T)
    models = {dev: sasrec_model(0, device=dev, **widths)
              for dev in ("cpu", "cuda")}
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    before = fa.flash_attention_bwd_dkv.launches
    losses = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev, m in models.items():
            trainer = Trainer(m, DenseAdam(m.parameters(), SAS_LR,
                                           eps=1e-5), sasrec_loss)
            losses[dev] = [float(trainer.step(sasrec_batch(B, T, s)))
                           for s in (0, 1, 2)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if fa.flash_attention_bwd_dkv.launches != before + 3 * 2:
        fail("the small card model did not take the flash kernels")
    log(f"[sasrec small] f32 losses cuda {losses['cuda']} cpu "
        f"{losses['cpu']}")
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]),
                               rtol=1e-5, atol=1e-5)
    cpu_params = dict(models["cpu"].named_parameters())
    err = 0.0
    for name, p in models["cuda"].named_parameters():
        torch.testing.assert_close(p.detach().cpu(), cpu_params[name].detach(),
                                   rtol=1e-5, atol=1e-5)
        err = max(err, (p.detach().cpu() - cpu_params[name].detach())
                  .abs().max().item())
    log(f"[sasrec small] parameters after 3 steps: max_abs_err {err!r}")


def run_sasrec(seed: int, profile: bool) -> dict:
    """The SASRec phases; returns the flash kernels' entries."""
    import torch

    from keras_rs_tpu_torch.models.sasrec import sasrec_loss
    from keras_rs_tpu_torch.training.train_state import DenseAdam
    from keras_rs_tpu_torch.training.trainer import Trainer, batch_to_device

    dev = torch.device("cuda", 0)
    checks = {label: phase_flash_kernel(label, B, T, H, hd, dt, seed)
              for label, B, T, H, hd, dt in FLASH_SHAPES}
    phase_sasrec_small()

    model = sasrec_model(seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[sasrec model] 2 blocks, 1 head, hidden 50, MLP 50, "
        f"{SAS_ITEMS} items, T {SAS_T}: {n_params} parameters")
    trainer = Trainer(model, DenseAdam(model.parameters(), SAS_LR),
                      sasrec_loss)
    fixed = batch_to_device(sasrec_batch(SAS_BATCH, SAS_T, seed), dev)

    # --- main path: train, then serve -------------------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms, losses = [], []

    def timed_step(batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.step(batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))

    for _ in range(FIXED_STEPS):
        timed_step(fixed)
    log(f"[sasrec train] fixed batch losses {losses}")
    if not all(map(math.isfinite, losses)):
        fail("SASRec: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"SASRec loss did not fall: {losses[0]} -> {losses[-1]}")
    for s in range(FRESH_STEPS):
        timed_step(sasrec_batch(SAS_BATCH, SAS_T, seed + 1 + s))
    log(f"[sasrec train] fresh batch losses {losses[FIXED_STEPS:]}")
    if not all(map(math.isfinite, losses)):
        fail("SASRec: non-finite loss on fresh batches")
    n_steps = FIXED_STEPS + FRESH_STEPS
    trained = launch_counts()
    per_step = len(model.blocks)
    if any(trained[name] != n_steps * per_step for name in FLASH_KERNELS):
        fail(f"flash kernels launched {trained} in {n_steps} steps of "
             f"{per_step} blocks")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    median = statistics.median(step_ms)
    log(f"[sasrec train] step ms {step_ms}; median {median!r} ms "
        f"({SAS_BATCH / median * 1e3:.0f} sequences/s, "
        f"{SAS_BATCH * SAS_T / median * 1e3:.0f} positions/s); peak device "
        f"memory {peak_gb:.2f} GB; launches {trained}")

    params = [p.detach().clone() for p in model.parameters()]
    retrieval = model.make_retrieval(k=SAS_TOP_K)
    fwd_ms, topk_ms, first = [], [], None
    with torch.no_grad():
        for s in range(SCORE_BATCHES):
            hist = torch.from_numpy(sasrec_batch(
                SAS_SERVE_USERS, SAS_T, seed + 100 + s, pad="right",
            )["item_history"]).to(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            user = model(hist)
            ev[1].record()
            scores, ids = retrieval(user)
            ev[2].record()
            torch.cuda.synchronize()
            fwd_ms.append(ev[0].elapsed_time(ev[1]))
            topk_ms.append(ev[1].elapsed_time(ev[2]))
            if tuple(user.shape) != (SAS_SERVE_USERS, 50) or not bool(
                    torch.isfinite(user).all()):
                fail(f"user states: shape {tuple(user.shape)} or non-finite")
            if tuple(ids.shape) != (SAS_SERVE_USERS, SAS_TOP_K) or not (
                    0 <= int(ids.min()) and int(ids.max()) <= SAS_ITEMS):
                fail(f"top-{SAS_TOP_K} ids: shape {tuple(ids.shape)}, range "
                     f"[{int(ids.min())}, {int(ids.max())}]")
            if not bool(torch.isfinite(scores).all()) or bool(
                    (scores[:, 1:] > scores[:, :-1]).any()):
                fail("top-k scores non-finite or out of order")
            if first is None:
                first = (hist, user)
    served = launch_counts()
    if served["flash_attention_fwd"] != (
            trained["flash_attention_fwd"] + SCORE_BATCHES * per_step):
        fail(f"serving launched B5 {served['flash_attention_fwd']} - "
             f"{trained['flash_attention_fwd']} times")
    if any(served[n] != trained[n] for n in FLASH_KERNELS[1:]):
        fail("serving launched a backward kernel")
    if not all(torch.equal(a, b.detach())
               for a, b in zip(params, model.parameters())):
        fail("serving changed the parameters")
    log(f"[sasrec serve] {SCORE_BATCHES} batches of {SAS_SERVE_USERS} "
        f"users: forward ms {fwd_ms}, top-{SAS_TOP_K} ms {topk_ms}; "
        f"launches {served}")

    # The served states against the einsum path on the first batch (TF32
    # off; no kernel runs on that path).
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for block in model.blocks:
            block.attention.use_flash = False
        with torch.no_grad():
            ref = model(first[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for block in model.blocks:
            block.attention.use_flash = "auto"
    err = (first[1] - ref).abs().max().item()
    log(f"[sasrec serve] user states vs the einsum path: max_abs_err "
        f"{err!r}")
    torch.testing.assert_close(first[1], ref, rtol=1e-4, atol=1e-4)
    del ref, first

    if profile:
        phase_profile("sasrec", trainer.step, fixed, SASREC_PROFILE_PARTS)
    del model, trainer, fixed
    torch.cuda.empty_cache()
    a = checks["a"]
    log(f"[flash] shape (a) fwd + dQ + dK/dV kernels "
        f"{sum(a[n]['ms'] for n in FLASH_KERNELS)!r} ms against "
        f"scaled_dot_product_attention forward + backward "
        f"{a['sdpa_fwd_bwd_ms']!r} ms")
    return [{
        "name": name,
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/flash_attention.cu",
        "replaces": FLASH_REPLACES[name],
        "launches": served[name],
        **a[name],
    } for name in FLASH_KERNELS]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and the batches")
    parser.add_argument("--profile", action="store_true",
                        help="also profile 3 training steps of each model")
    args = parser.parse_args()

    if not (ROOT / "keras_rs_tpu_torch" / "csrc").is_dir():
        fail(f"keras_rs_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this runs on a GPU only")

    card = nvidia_smi_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.cuda.set_device(torch.device("cuda", 0))
    t0 = time.perf_counter()
    phase_build()

    kernels = [run_dlrm(args.seed, args.profile)]
    log(f"[time] DLRM phases done at {time.perf_counter() - t0:.1f} s")
    kernels += run_sasrec(args.seed, args.profile)
    log(f"[time] SASRec phases done at {time.perf_counter() - t0:.1f} s")

    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
