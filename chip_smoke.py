#!/usr/bin/env python3
"""Smoke run of keras_rs_tpu_torch on one CUDA GPU (PyTorch + CUDA only).

Drives the port's main paths through the entry points a user calls,
each at the full width of a model the repo supports, with random weights
from --seed:

  * DLRM-DCNv2 training step and scoring forward at the MLPerf widths
    (examples/ml_perf/configs.py: 26 Criteo features with their multi-hot
    sizes, dim 128, bottom MLP (512, 256, 128), 3 DCNv2 layers of
    projection 512, top MLP (1024, 1024, 512, 256, 1), lr 0.0034, batch
    16384, bf16 compute; synthetic Criteo-shaped ids), in three table
    modes:
      - packed: f32 tables with Adagrad, each vocabulary capped at
        4,000,000 rows; kernel B1 (csrc/row_ops.cu);
      - capacity mode on the uncut vocabulary: bf16 tables with row-wise
        Adagrad, one stack of 204,102,451 rows (53.1 GB); kernel B3;
      - two short paths at the 4M cap: bf16 tables with Adagrad (B4, k =
        2) and f32 tables with Adam (packed [R, 3, 128], B2).
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
  2. dlrm kernel   B1 against its plain version at the packed slice's
                   shapes;
  3. dlrm small    a small f32 DLRM, 3 steps on the card and on the CPU;
  4. dlrm train    8 steps on one fixed batch (loss falls), then 3 fresh
                   batches; B1 launches once per step per stack;
  5. dlrm score    3 fresh request batches: finite logits, state
                   unchanged, no kernel launch;
  6. scatter       B4 (bf16 + f32 streams) and B2 ([R, 3, 128] f32)
     kernels       against their plain versions at the 4M-cap batch's N
                   and n_valid: bit-exact, rows outside the live prefix
                   untouched; CUDA-event times, the byte bound and the
                   index_copy_ yardstick;
  7. capacity      build the uncut bf16 + row-wise Adagrad model, B3
                   against its plain version at its batch's N and
                   n_valid, 8 + 3 training steps (B3 once per step, no
                   other kernel, step counter 11, peak device memory
                   under 72 GB), 3 scoring batches (finite logits, table
                   and accumulator unchanged, no launch);
  8. capacity      a small capacity-mode DLRM, 3 steps on the card and on
     small         the CPU (bf16 rows within one ulp per step);
  9. short paths   bf16 + Adagrad (B4 once per step) and f32 + Adam (B2
                   once per step): 3 steps on one batch (loss falls), one
                   scoring batch;
 10. flash kernel  B5, B6, B7 each against its plain version at (a) the
                   slice (B 128, H 1, T 1024, hd 50, f32), (b) the
                   published T 200, (c) bf16 B 8, H 4, T 4096, hd 64, and
                   B5 alone at (d) the serving launch (B 1024, T 1024,
                   hd 50, f32; compared on 128 rows of the batch), with
                   CUDA-event times, the bound, the layers' einsum path
                   (forward, at a-c) and scaled_dot_product_attention
                   (forward; forward + backward; backward alone, the
                   library time of B6 and B7) as yardsticks only;
 11. sasrec small  a small f32 SASRec (T 512) 3 Adam steps on the card
                   (kernels) and on the CPU (einsum path): losses and
                   parameters agree;
 12. sasrec train  8 steps on one fixed batch (loss falls), then 3 fresh
                   batches; B5, B6, B7 launch once per block per step;
 13. sasrec serve  3 batches of 1024 users under no_grad: user states,
                   top-10 ids in [0, 3706], parameters unchanged, B5 only;
 14. profile       only with --profile: torch.profiler over 3 more steps
                   of the packed DLRM, the capacity DLRM and SASRec,
                   device time per step by part.

The launch counts in the kernels line are those of the main paths alone:
every count is set to 0 just before a path's train-and-serve run and read
just after it (B1 from the packed path, B2 from f32 + Adam, B3 from
capacity mode, B4 from bf16 + Adagrad, B5-B7 from SASRec).

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
CHECK_ROWS = 6_000_000  # rows of the tables the kernel checks run on
FIXED_STEPS = 8
FRESH_STEPS = 3
SCORE_BATCHES = 3
SHORT_STEPS = 3  # the two short 4M-cap paths: steps on one batch
# Capacity mode on the uncut vocabulary: the 9 tables of >= 21,000 rows
# (5 x 40M, 3,067,956, 590,152, 405,282, 39,060) and the sink row.
CAPACITY_ROWS = 204_102_451
PEAK_LIMIT_GB = 72.0

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
    ("d", SAS_SERVE_USERS, SAS_T, 1, 50, "float32"),
]
#: Shapes at which only the forward (B5) runs: the serving launch.
FLASH_FORWARD_ONLY = {"d"}
#: Batch rows on which a forward-only shape meets its plain version (the
#: plain scores are [rows, H, T, T] f32).
FLASH_PLAIN_ROWS = 128
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
FLASH_REPLACES = {
    "flash_attention_fwd": "keras_rs_tpu/ops/flash_attention.py:48",
    "flash_attention_bwd_dq": "keras_rs_tpu/ops/flash_attention.py:85",
    "flash_attention_bwd_dkv": "keras_rs_tpu/ops/flash_attention.py:116",
}
# H100 SXM published peaks: HBM bytes/s, and FLOP/s by input type. bf16
# runs on the tensor cores at 989 TFLOP/s. f32 inputs: B5-B7 run each
# product as three TF32 tensor-core products (big*big + big*small +
# small*big, to stay within 1e-5 of f32 math), so their rate is the TF32
# peak over three, 495 / 3 = 165 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12}


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


def slice_config(batch: int = BATCH, vocab_cap: int | None = VOCAB_CAP,
                 **overrides):
    """The MLPerf DLRM-DCNv2 at batch `batch`, each vocabulary capped at
    `vocab_cap` rows (None: uncut); `overrides` go to DLRMConfig
    (table_dtype, embedding_optimizer)."""
    from keras_rs_tpu_torch.models.dlrm import DLRMConfig

    vocab = [v if vocab_cap is None else min(v, vocab_cap)
             for v in CRITEO_VOCAB_SIZES]
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
        **overrides,
    )


def _entry_name(mangled: str) -> str:
    """A readable name for a ptxas entry: B1's functor, the scatter
    kernel, or a flash kernel with its head-dim tile and input type."""
    m = re.search(r"kernelINS_\d+(\w+?)E", mangled)
    if m:
        return m.group(1)
    if "scatter_rows_kernel" in mangled:
        return "scatter_rows_kernel"
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
        # ptxas -v: one line per kernel (registers, spilled bytes).
        entry, spills = "?", ""
        for line in lib.build_log.splitlines():
            m = re.search(r"Compiling entry function '(.*?)'", line)
            if m:
                entry = _entry_name(m.group(1))
            elif "bytes spill" in line:
                stores, loads = re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                    line).groups()
                spills = ("no spills" if stores == loads == "0" else
                          f"SPILLS {stores} B stored, {loads} B loaded")
            elif "registers" in line:
                used = re.search(r"Used (\d+) registers", line).group(1)
                log(f"[build]   {entry}: {used} registers, {spills}")


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
    idx = check_indices(n, nv, g)
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

    ms, plain_ms, times = time_in_turns(
        lambda: row_ops.apply_scatter_row_blocks(got, *args),
        lambda: row_ops.apply_scatter_row_blocks_reference(got, *args))
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


def check_indices(n: int, nv: int, generator):
    """[n] int32 on the card: sorted distinct random rows of the first
    CHECK_ROWS - 1 in the live prefix, the sink (CHECK_ROWS - 1) after
    it, as the lookup's dedup list lays them out."""
    import torch

    dev = generator.device
    live = torch.randperm(CHECK_ROWS - 1, generator=generator,
                          device=dev)[:nv]
    idx = torch.full((n,), CHECK_ROWS - 1, dtype=torch.int32, device=dev)
    idx[:nv] = live.sort().values.to(torch.int32)
    return idx


def time_in_turns(kernel, plain, iters: int = 10):
    """CUDA-event means of the kernel and its plain version, in turns
    (plain, kernel, kernel, plain) after one warm-up call of each."""
    kernel(), plain()
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(cuda_time_ms(
            kernel if name == "kernel" else plain, iters))
    return (statistics.mean(times["kernel"]), statistics.mean(times["plain"]),
            times)


def phase_scatter_kernel(name: str, shapes, unique_slots, sink: int,
                         seed: int) -> dict:
    """One row-scatter wrapper (B2, B3 or B4) against its plain version
    on CHECK_ROWS-row tables of the given (dtype, row shape) streams, with
    a real batch's N and n_valid: bit-exact, and no row outside the live
    prefix written. Times the kernel, the plain version and the
    `index_copy_` yardstick (one call per stream on the live prefix)."""
    import torch

    from keras_rs_tpu_torch.ops import row_ops

    dev = unique_slots.device
    n = unique_slots.shape[0]
    nv = int((unique_slots != sink).sum())
    if not 0 < nv < CHECK_ROWS:
        fail(f"n_valid {nv} outside (0, {CHECK_ROWS})")
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = check_indices(n, nv, g)
    tables = [torch.randn((CHECK_ROWS,) + shape, generator=g, device=dev)
              .to(dtype) for dtype, shape in shapes]
    rows = [torch.randn((n,) + shape, generator=g, device=dev).to(dtype)
            for dtype, shape in shapes]
    for t, r in zip(tables, rows):
        r[nv:] = t[CHECK_ROWS - 1]  # the tail: the sink's own bytes
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    fn = {
        "scatter_rows": lambda ts: row_ops.scatter_rows(
            ts[0], idx, rows[0], n_valid),
        "_scatter_rows_multi": lambda ts: row_ops._scatter_rows_multi(
            ts, idx, rows, n_valid),
        "scatter_row_blocks": lambda ts: row_ops.scatter_row_blocks(
            ts[0], idx, rows[0], n_valid),
    }[name]
    got = [t.clone() for t in tables]
    want = [t.clone() for t in tables]
    fn(got)
    row_ops.scatter_rows_reference(want, idx, rows, n_valid)
    torch.cuda.synchronize()
    live = idx[:nv].long()
    outside = torch.ones(CHECK_ROWS, dtype=torch.bool, device=dev)
    outside[live] = False
    err = 0.0
    for t, a, b in zip(tables, got, want):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            fail(f"{name} differs from its plain version")
        if not torch.equal(a[outside], t[outside]):
            fail(f"{name} wrote rows outside the live prefix")
        if torch.equal(a[live], t[live]):
            fail(f"{name} left the live rows unchanged")
        err = max(err, (a[live].float() - b[live].float()).abs().max().item())
    del want, outside
    row_bytes = [math.prod(shape) * torch.tensor([], dtype=dtype)
                 .element_size() for dtype, shape in shapes]
    ms, plain_ms, times = time_in_turns(
        lambda: fn(got),
        lambda: row_ops.scatter_rows_reference(got, idx, rows, n_valid))
    lib_rows = [r[:nv] for r in rows]
    library_ms = cuda_time_ms(lambda: [
        t.index_copy_(0, live, r) for t, r in zip(got, lib_rows)], 10)
    # Bytes: each live position's source rows read, destination rows
    # written, and its index read.
    moved = nv * (2 * sum(row_bytes) + 4)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] {name} streams "
        f"{[(str(d).split('.')[-1], (CHECK_ROWS,) + s) for d, s in shapes]} "
        f"N={n} n_valid={nv}: max_abs_err {err!r} (bit-exact); kernel "
        f"{ms!r} ms ({moved / ms / 1e6:.1f} GB/s of {moved / 1e9:.3f} GB), "
        f"plain {plain_ms!r} ms, index_copy_ {library_ms!r} ms, bound "
        f"{bound_ms!r} ms (bytes, {bound_ms / ms:.1%} of it); runs {times}")
    del got, tables, rows, lib_rows
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms}


def phase_small_reference(label: str, bound: str, expect: dict,
                          **overrides) -> None:
    """The port on the card against the port on the CPU (whose plain
    paths the CPU tests hold to the JAX package): a small model with f32
    dense layers, identical parameters and state, 3 steps; the card's
    kernel launches must be `expect`.

    `bound` "f32": losses and tables within 1e-5 (sums in another
    order). "bf16 tables": the card and the CPU round the bf16 rows
    stochastically with different random bits, so tables within one bf16
    ulp per step taken (3) plus 1e-4 absolute (an element whose gradient
    nearly cancels takes an update that the f32 differences change in
    relative terms), losses within 1e-4, as the CPU tests hold the port
    to the JAX package in this mode."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import (
        DLRMConfig,
        DLRMDCNv2,
        bce_loss,
    )
    from keras_rs_tpu_torch.ops import row_ops
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
        compute_dtype=None, dense_output_dtype="float32", **overrides,
    )
    models = {
        dev: DLRMDCNv2(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev,
        )
        for dev in ("cpu", "cuda")
    }
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    before = launch_counts()
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
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    log(f"[small {label}] losses cuda {losses['cuda']} cpu {losses['cpu']}; "
        f"card launches {launched}")
    if launched != expect:
        fail(f"small {label}: card launches {launched}, expected {expect}")
    ta = models["cuda"].embedding_layer.get_embedding_tables()
    tb = models["cpu"].embedding_layer.get_embedding_tables()
    if bound == "f32":
        torch.testing.assert_close(
            torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
            rtol=1e-5, atol=1e-5,
        )
        for k in tb:
            torch.testing.assert_close(ta[k].cpu(), tb[k], rtol=1e-5,
                                       atol=1e-5)
        return
    torch.testing.assert_close(
        torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"]),
        rtol=1e-4, atol=1e-4,
    )
    worst = 0.0
    for k in tb:
        a, b = ta[k].cpu().float(), tb[k].float()
        m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0**-126)
        ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
        excess = ((a - b).abs() - 3 * ulp).max().item()
        worst = max(worst, excess)
        if excess > 1e-4:
            fail(f"small {label}: table {k} differs by {excess!r} beyond "
                 "3 bf16 ulp")
    log(f"[small {label}] tables within 3 bf16 ulp + {max(worst, 0.0)!r}; "
        f"loss diff {max(abs(a - b) for a, b in zip(losses['cuda'], losses['cpu']))!r}")


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
CAPACITY_PROFILE_PARTS = [
    ("stacked lookup backward", "_StackLookupBackward", "total"),
    ("  B3 row scatter kernel", "kernel:scatter_rows_kernel", "self"),
    ("  segment-sum index_add_", "aten::index_add_", "self"),
    ("  row-wise accumulator index_copy_", "aten::index_copy_", "total"),
    ("  stochastic rounding bits", "aten::random_", "total"),
    ("gathers, whole step", "aten::index", "total"),
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


def state_checksum(state: dict) -> int:
    """Sum of the 32-bit words of a stack state's table and every slot,
    in chunks (no full-size copy)."""
    import torch

    total = torch.zeros((), dtype=torch.int64, device=state["table"].device)
    for t in [state["table"], *state.get("slots", {}).values()]:
        words = t.view(torch.int32).view(t.shape[0], -1)
        for lo in range(0, words.shape[0], 1 << 20):
            total += words[lo : lo + (1 << 20)].sum(dtype=torch.int64)
    return int(total)


ROW_KERNELS = ("apply_scatter_row_blocks", "scatter_row_blocks",
               "scatter_rows", "_scatter_rows_multi")


def reset_launch_counts() -> None:
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops

    for name in ROW_KERNELS:
        getattr(row_ops, name).launches = 0
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def launch_counts() -> dict[str, int]:
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops

    counts = {name: getattr(row_ops, name).launches for name in ROW_KERNELS}
    counts.update({name: getattr(fa, name).launches
                   for name in FLASH_KERNELS})
    return counts


def dlrm_batch(cfg, s: int) -> dict:
    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch

    return criteo_like_batch(cfg.global_batch_size,
                             vocab_sizes=cfg.vocab_sizes,
                             multi_hot_sizes=cfg.multi_hot_sizes, seed=s)


def build_dlrm(label: str, cfg, seed: int):
    """The model on the card, with its build time and state sizes."""
    import torch

    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emb = model.embedding_layer
    parts, nbytes = [], 0
    for i in range(len(emb.stacks)):
        state = emb.stack_state(i)
        for name, t in [("table", state["table"]),
                        *state.get("slots", {}).items()]:
            parts.append(f"{name} {tuple(t.shape)} "
                         f"{str(t.dtype).split('.')[-1]}")
            nbytes += t.numel() * t.element_size()
    log(f"[{label} model] built in {build_s:.1f} s: {len(model.large_idx)} "
        f"stacked tables in {len(emb.stacks)} stack(s), state {parts} = "
        f"{nbytes / 1e9:.2f} GB, {len(model.small_idx)} small tables, "
        f"{sum(p.numel() for p in model.parameters())} dense parameters; "
        f"device memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB")
    return model


def drive_dlrm(label: str, model, cfg, seed: int, fixed, expect: dict,
               fixed_steps: int, fresh_steps: int, score_batches: int,
               preprocess, profile_parts=None) -> dict:
    """The main path of one DLRM configuration: `fixed_steps` training
    steps on the preprocessed batch `fixed` (the loss must fall), then
    `fresh_steps` on fresh batches, then `score_batches` scoring batches
    under no_grad (finite logits, state unchanged, no kernel launch).
    Every launch count is set to 0 just before and read just after: each
    kernel in `expect` must launch that many times per step and stack,
    every other kernel never. Returns the counts and the timings."""
    import torch

    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    emb = model.embedding_layer
    n_stacks = len(emb.stacks)
    B = cfg.global_batch_size
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

    for _ in range(fixed_steps):
        timed_step(fixed)
    log(f"[{label} train] fixed batch losses {losses}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    for s in range(fresh_steps):
        timed_step(preprocess(dlrm_batch(cfg, seed + 1 + s)))
    if fresh_steps:
        log(f"[{label} train] fresh batch losses {losses[fixed_steps:]}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: non-finite loss on fresh batches")
    n_steps = fixed_steps + fresh_steps
    trained = launch_counts()
    want = {name: expect.get(name, 0) * n_steps * n_stacks
            for name in trained}
    if trained != want:
        fail(f"{label}: launches {trained} in {n_steps} steps of {n_stacks} "
             f"stack(s), expected {want}")
    steps_done = [float(emb.stack_state(i)["step"]) for i in range(n_stacks)]
    if steps_done != [float(n_steps)] * n_stacks:
        fail(f"{label}: stack step counters {steps_done}, expected "
             f"{n_steps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    median = statistics.median(step_ms)
    log(f"[{label} train] step ms {step_ms}; median {median!r} ms "
        f"({B / median * 1e3:.0f} examples/s); peak device memory "
        f"{peak_gb:.2f} GB; launches "
        f"{ {k: v for k, v in trained.items() if v} }; step counters "
        f"{steps_done}")

    sums = [state_checksum(emb.stack_state(i)) for i in range(n_stacks)]
    score_ms = []
    with torch.no_grad():
        for s in range(score_batches):
            pre = preprocess(dlrm_batch(cfg, seed + 100 + s))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = model(pre)
            end.record()
            torch.cuda.synchronize()
            score_ms.append(start.elapsed_time(end))
            if tuple(logits.shape) != (B,):
                fail(f"{label}: logits shape {tuple(logits.shape)}")
            if not bool(torch.isfinite(logits).all()):
                fail(f"{label}: non-finite logits")
    if [state_checksum(emb.stack_state(i))
            for i in range(n_stacks)] != sums:
        fail(f"{label}: scoring changed the embedding state")
    if launch_counts() != trained:
        fail(f"{label}: scoring launched a kernel")
    log(f"[{label} score] {score_batches} batches of {B}: forward ms "
        f"{score_ms}; state checksums (table and slots) unchanged")
    if profile_parts is not None:
        phase_profile(label, step, fixed, profile_parts)
    del opt, step
    return {"launches": trained, "peak_gb": peak_gb, "median_ms": median}


def make_preprocess(model, times: list):
    """model.preprocess, timed on the host (host-to-device copy
    included)."""
    import torch

    def preprocess(raw):
        t = time.perf_counter()
        pre = model.preprocess(raw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return pre

    return preprocess


def run_dlrm(seed: int, profile: bool) -> tuple[dict, object, int]:
    """The packed DLRM path (f32 tables, Adagrad, 4M-row cap, kernel B1);
    returns B1's kernel entry and the fixed batch's unique_slots (on the
    CPU) with its sink."""
    import torch

    cfg = slice_config()
    model = build_dlrm("dlrm", cfg, seed)
    preprocess_s = []
    preprocess = make_preprocess(model, preprocess_s)
    fixed = preprocess(dlrm_batch(cfg, seed))
    stack = model.embedding_layer.stacks[0]
    coo = fixed["large_pre"]["sharded"][stack.name]
    kernel = phase_kernel(coo["unique_slots"], stack.sink_slot, seed)
    phase_small_reference("f32", "f32", {"apply_scatter_row_blocks": 3})
    run = drive_dlrm(
        "dlrm", model, cfg, seed, fixed, {"apply_scatter_row_blocks": 1},
        FIXED_STEPS, FRESH_STEPS, SCORE_BATCHES, preprocess,
        DLRM_PROFILE_PARTS if profile else None)
    log(f"[dlrm host] preprocessing s per batch {preprocess_s}; median "
        f"{statistics.median(preprocess_s)!r} s")
    slots = coo["unique_slots"].cpu()
    del model, fixed, coo, preprocess
    torch.cuda.empty_cache()
    return {
        "name": "apply_scatter_row_blocks",
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/row_ops.cu",
        "replaces": "keras_rs_tpu/ops/row_ops.py:472",
        "launches": run["launches"]["apply_scatter_row_blocks"],
        **kernel,
    }, slots, stack.sink_slot


def run_capacity(seed: int, profile: bool) -> dict:
    """Capacity mode on the uncut Criteo vocabulary: bf16 tables with
    row-wise Adagrad in one 204,102,451-row stack; B3 checked at this
    batch's N and n_valid, then trained and scored. Returns B3's entry."""
    import torch

    cfg = slice_config(vocab_cap=None, table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad")
    model = build_dlrm("capacity", cfg, seed)
    (stack,) = model.embedding_layer.stacks
    if stack.global_rows != CAPACITY_ROWS or stack.packed_state:
        fail(f"capacity stack: {stack.global_rows} rows, packed "
             f"{stack.packed_state}; expected {CAPACITY_ROWS}, split")
    preprocess_s = []
    preprocess = make_preprocess(model, preprocess_s)
    fixed = preprocess(dlrm_batch(cfg, seed))
    coo = fixed["large_pre"]["sharded"][stack.name]
    kernel = phase_scatter_kernel(
        "scatter_rows", [(torch.bfloat16, (128,))], coo["unique_slots"],
        stack.sink_slot, seed)
    run = drive_dlrm(
        "capacity", model, cfg, seed, fixed, {"scatter_rows": 1},
        FIXED_STEPS, FRESH_STEPS, SCORE_BATCHES, preprocess,
        CAPACITY_PROFILE_PARTS if profile else None)
    if run["peak_gb"] >= PEAK_LIMIT_GB:
        fail(f"capacity: peak device memory {run['peak_gb']:.2f} GB >= "
             f"{PEAK_LIMIT_GB}")
    log(f"[capacity host] preprocessing s per batch {preprocess_s}; median "
        f"{statistics.median(preprocess_s)!r} s")
    del model, fixed, coo, preprocess
    torch.cuda.empty_cache()
    return {
        "name": "scatter_rows",
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/row_ops.cu",
        "replaces": "keras_rs_tpu/ops/row_ops.py:56",
        "launches": run["launches"]["scatter_rows"],
        **kernel,
    }


def run_short(label: str, seed: int, slots_4m, expect: dict,
              **overrides) -> dict:
    """A short path at the 4M-row cap: 3 steps on one batch, 1 scoring
    batch. Its fixed batch's unique_slots must equal the packed path's
    (same cap, same seed), so the kernel checks made with those held the
    kernel at this path's N and n_valid. Returns the launch counts."""
    import torch

    cfg = slice_config(**overrides)
    model = build_dlrm(label, cfg, seed)
    preprocess = make_preprocess(model, [])
    fixed = preprocess(dlrm_batch(cfg, seed))
    (stack,) = model.embedding_layer.stacks
    coo = fixed["large_pre"]["sharded"][stack.name]
    if not torch.equal(coo["unique_slots"].cpu(), slots_4m):
        fail(f"{label}: unique_slots differ from the packed path's")
    run = drive_dlrm(label, model, cfg, seed, fixed, expect, SHORT_STEPS, 0,
                     1, preprocess)
    del model, fixed, coo, preprocess
    torch.cuda.empty_cache()
    return run["launches"]


def run_row_scatter(seed: int, profile: bool, slots_4m, sink_4m) -> list:
    """B4 and B2 at the 4M-cap batch's N and n_valid, the capacity path
    (B3), the two short paths that launch B4 and B2, and the small
    capacity-mode model against the CPU. Returns the entries of B2, B3
    and B4."""
    import torch

    multi = phase_scatter_kernel(
        "_scatter_rows_multi",
        [(torch.bfloat16, (128,)), (torch.float32, (128,))],
        slots_4m.cuda(), sink_4m, seed + 1)
    blocks = phase_scatter_kernel(
        "scatter_row_blocks", [(torch.float32, (3, 128))],
        slots_4m.cuda(), sink_4m, seed + 2)
    b3 = run_capacity(seed, profile)
    phase_small_reference("capacity", "bf16 tables", {"scatter_rows": 3},
                          table_dtype="bfloat16",
                          embedding_optimizer="rowwise_adagrad")
    b4_launches = run_short("bf16 adagrad", seed, slots_4m,
                            {"_scatter_rows_multi": 1},
                            table_dtype="bfloat16",
                            embedding_optimizer="adagrad")
    b2_launches = run_short("f32 adam", seed, slots_4m,
                            {"scatter_row_blocks": 1},
                            embedding_optimizer="adam")
    entry = dict(route="cuda", source="keras_rs_tpu_torch/csrc/row_ops.cu")
    return [
        {"name": "scatter_row_blocks", **entry,
         "replaces": "keras_rs_tpu/ops/row_ops.py:331",
         "launches": b2_launches["scatter_row_blocks"], **blocks},
        b3,
        {"name": "_scatter_rows_multi", **entry,
         "replaces": "keras_rs_tpu/ops/row_ops.py:209",
         "launches": b4_launches["_scatter_rows_multi"], **multi},
    ]



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
    contract); dO is 0 on the others, as in SASRec. A forward-only shape
    runs B5 on the whole batch and compares its first FLASH_PLAIN_ROWS
    rows."""
    import torch
    import torch.nn.functional as F

    from keras_rs_tpu_torch.ops import flash_attention as fa

    forward_only = label in FLASH_FORWARD_ONLY
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
    # The batch rows held against the plain version.
    n = min(B, FLASH_PLAIN_ROWS) if forward_only else B
    plain_fwd_args = (q[:n], k[:n], v[:n], bias[:n], scale, True)

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
    want_out, want_lse = fa.flash_attention_fwd_reference(*plain_fwd_args)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out.float()).all())
            and bool(torch.isfinite(lse).all())):
        fail(f"({label}) forward: non-finite values on uncovered rows")
    errs = {"flash_attention_fwd": max(
        check("O", out[:n][rows[:n]], want_out[rows[:n]], tol),
        check("lse", lse[:n].transpose(1, 2)[rows[:n]],
              want_lse.transpose(1, 2)[rows[:n]],
              dict(rtol=1e-5, atol=1e-5)),
    )}
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, bias, scale, True),
            lambda: fa.flash_attention_fwd_reference(*plain_fwd_args)),
    }
    if not forward_only:
        dout = dout * rows[:, :, None, None].to(dtype)
        delta = (dout.float() * want_out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, bias, dout, want_lse, delta.contiguous(), scale,
                True)
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        want_dq = fa.flash_attention_bwd_dq_reference(*args)
        want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        errs["flash_attention_bwd_dq"] = check("dQ", dq[rows],
                                               want_dq[rows], gtol)
        errs["flash_attention_bwd_dkv"] = max(
            check("dK", dk, want_dk, gtol), check("dV", dv, want_dv, gtol))
        del dq, dk, dv, want_dq, want_dk, want_dv
        calls["flash_attention_bwd_dq"] = (
            lambda: fa.flash_attention_bwd_dq(*args),
            lambda: fa.flash_attention_bwd_dq_reference(*args))
        calls["flash_attention_bwd_dkv"] = (
            lambda: fa.flash_attention_bwd_dkv(*args),
            lambda: fa.flash_attention_bwd_dkv_reference(*args))
    del out, lse, want_out

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
            f"plain {plain_ms!r} ms"
            + (f" (on {n} of the {B} batch rows)" if n < B else "")
            + f", bound {bound_ms!r} ms ({bound_by}, "
            f"{bound_ms / ms:.1%} of it); runs {times}")
    torch.cuda.empty_cache()

    if not forward_only:
        # The layers' einsum path (layers/attention.py below FLASH_MIN_T):
        # the same attention without a kernel, forward only.
        def einsum_path():
            return fa.attention_reference(q, k, v, causal=True,
                                          key_mask=mask)

        einsum_path()
        result["einsum_fwd_ms"] = cuda_time_ms(einsum_path, 5)
        log(f"[flash {label}] einsum path forward "
            f"{result['einsum_fwd_ms']!r} ms against B5 "
            f"{result['flash_attention_fwd']['ms']!r} ms")
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

    sdpa()
    sdpa_ms = cuda_time_ms(sdpa, 10)
    result["flash_attention_fwd"]["library_ms"] = sdpa_ms
    log(f"[flash {label}] yardstick scaled_dot_product_attention with the "
        f"boolean mask: forward {sdpa_ms!r} ms (B5 "
        f"{result['flash_attention_fwd']['ms']!r} ms, "
        f"{result['flash_attention_fwd']['ms'] / sdpa_ms:.2f}x)")
    if not forward_only:
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                *leaves, attn_mask=attn_mask, scale=scale).backward(dot)

        sdpa_fwd_bwd()
        result["sdpa_fwd_bwd_ms"] = cuda_time_ms(sdpa_fwd_bwd, 5)
        log(f"[flash {label}] yardstick forward+backward "
            f"{result['sdpa_fwd_bwd_ms']!r} ms (kernels fwd + dQ + dK/dV "
            f"{sum(result[name]['ms'] for name in FLASH_KERNELS)!r} ms)")
        # The backward alone (forward once, outside the timed window): the
        # one PyTorch call that computes dQ, with dK and dV beside it, so
        # the library time of B6 and of B7 alike.
        sdpa_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=attn_mask, scale=scale)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True)

        sdpa_bwd()
        bwd_ms = cuda_time_ms(sdpa_bwd, 5)
        for name in FLASH_KERNELS[1:]:
            result[name]["library_ms"] = bwd_ms
        log(f"[flash {label}] yardstick backward alone {bwd_ms!r} ms (B6 + "
            f"B7 {sum(result[n]['ms'] for n in FLASH_KERNELS[1:])!r} ms)")
        del leaves, sdpa_out
    del qt, kt, vt, dot, attn_mask
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
    """The port on the card (flash kernels: T 512 >= FLASH_MIN_T) against
    the port on the CPU (einsum path, held to the JAX package by the CPU
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
    d = checks["d"]["flash_attention_fwd"]
    log(f"[flash] B5 on the SASRec path: {trained['flash_attention_fwd']} "
        f"training launches at (a) {a['flash_attention_fwd']['ms']!r} ms, "
        f"{served['flash_attention_fwd'] - trained['flash_attention_fwd']} "
        f"serving launches at (d) {d['ms']!r} ms (bound {d['bound_ms']!r} "
        f"ms by {d['bound_by']}, scaled_dot_product_attention "
        f"{d['library_ms']!r} ms)")
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

    b1, slots_4m, sink_4m = run_dlrm(args.seed, args.profile)
    log(f"[time] packed DLRM phases done at {time.perf_counter() - t0:.1f} s")
    kernels = [b1] + run_row_scatter(args.seed, args.profile, slots_4m,
                                     sink_4m)
    log(f"[time] capacity and row-scatter phases done at "
        f"{time.perf_counter() - t0:.1f} s")
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
