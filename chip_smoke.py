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
        Adagrad, one stack of 204,102,451 rows (53.1 GB); the split
        update's kernel (apply_split_rows) and B3;
      - two short paths at the 4M cap: bf16 tables with Adagrad (B4, k =
        2) and f32 tables with Adam (packed [R, 3, 128], B2).
  * the same DLRM through the ml_perf entry point
    (keras_rs_tpu_torch/examples/ml_perf/main.py) with the COO
    preprocessing on the device inside the step, and in host mode; and
    trained from Criteo-schema TFRecord files (the reference's
    file-batched schema, 4,096 samples per proto) that the script writes
    with the port's writer and reads through the native reader
    (data/native_io.py, data/criteo.py);
  * SASRec at the published ML-1M widths (models/sasrec.py defaults: 2
    blocks, 1 head, hidden 50, MLP 50, 3,706 items; Adam lr 0.005, batch
    128, f32) with the long-history context T = 1024, trained through
    Trainer + sasrec_loss and served by the last state + top-10
    BruteForceRetrieval. Markov sessions (branching 12, noise 0.2); a
    quarter of each batch cut to a random history of >= 16 items and
    padded with id 0. Kernels B5-B7 (csrc/flash_attention.cu).
  * two-tower retrieval (models/two_tower.py) on the 1M x 128 corpus of
    the repo's retrieval measurement (BASELINE.md:442): TwoTower(1M, 1M,
    128, tower_units=(256, 128)), f32, batch 4,096 of Zipf(1.1) ids,
    DenseAdagrad 0.2, in_batch_softmax_loss with logQ; served by exact
    chunked top-10, brute force at 10M x 128 and the k-means IVF; and
    listwise ranking (examples/listwise_ranking.py's path at 200k users,
    100k items, dim 128, lists of 100, batch 1,024) and BasicRanking at
    examples/basic_ranking.py's widths. No kernel: the reference's
    retrieval and ranking code reaches no Pallas kernel.
  * serving (keras_rs_tpu_torch/serving.py): the trained packed DLRM
    frozen (DistributedEmbedding.freeze) in f32 and in int8 in the
    "rows", "packed" and "fused" layouts, serving Ragged request
    batches eagerly and through serving.aot_compile (CUDA graphs), and
    its slot-free serving_copy(); the capacity-mode model on the uncut
    vocabulary frozen to int8 beside its training state, then served
    alone; torch.export artifacts of an int8 DLRM and a retrieval
    service. No kernel: the reference's serving path reaches no Pallas
    kernel.

  * GRU4Rec sequential retrieval (models/gru4rec.py) at the JAX module's
    default width (dim 128) over MovieLens-1M's 3,706 items, histories
    of 10, batch 4,096, Adam 0.01, through the full Trainer (prefetch,
    validation, checkpoints, metrics log, evaluate), resumed from its
    checkpoint and served by top-10 retrieval; the full-rank
    FeatureCross and DotInteraction at DLRM widths; a learning-rate
    schedule on the packed DLRM (B1 reads it from the device); the
    ml_perf entry point's checkpoint resume and profiling. No new
    kernel: the reference's GRU (lax.scan over jnp), Trainer,
    checkpoints, FeatureCross and DotInteraction reach no Pallas kernel.
  * pipelined embedding (training/pipelined.py: the next batch's lookup,
    and its device COO transform, on a side CUDA stream beside the dense
    compute, one update old) through the ml_perf entry point at full
    width (--pipeline_embedding, packed f32 + Adagrad, B1) and in the
    split layout (bf16 tables + row-wise Adagrad at the 4M cap, the split
    kernel and B3); the
    six walkthrough examples (basic_ranking, basic_retrieval,
    listwise_ranking, multi_task, deep_recommender, sas_rec) at their
    default sizes, which reach no kernel.
  * the benchmark entry point (keras_rs_tpu_torch/bench.py, the port of
    the repository's bench.py: bench.py's DLRM-DCNv2 widths, batch
    8,192): ours (device COO, stacked lookup, B1), the dense-only step,
    the naive dense-table baseline, the pipelined step and the flagship
    valence (the Criteo multi-hot mix at a 1M cap, B1), and the bf16 +
    row-wise Adagrad mix (the split kernel and B3).
  * the sharded embedding at D = 2 (parallel/, DistributedEmbedding over
    a mesh of ranks): two spawned ranks on cuda:0 joined by gloo (NCCL
    refuses two ranks on one device), each with its shard of the tables,
    its 8,192 samples of each batch of 16,384 and a replica of the dense
    model: the ml_perf entry point at full width (packed f32 + Adagrad
    at the 4M cap, device COO with its all_to_all, B1 on each shard), the
    split layout (bf16 + row-wise Adagrad, the split kernel and B3 on
    each shard), capacity
    auto-grow and nested feature configs.

Phases (any failure raises, so the exit code is not 0):
  1. build         all CUDA sources of keras_rs_tpu_torch/csrc, one nvcc
                   each, started together; ptxas registers and spills;
  2. dlrm kernel   B1 against its plain version at the packed slice's
                   shapes;
  3. dlrm small    a small f32 DLRM, 3 steps on the card and on the CPU;
  4. dlrm train    8 steps on one fixed batch (loss falls), then 3 fresh
                   batches; B1 launches once per step per stack (its
                   wrapper runs in the first three steps, the later
                   ones replay the step's CUDA graph);
  5. dlrm score    3 fresh request batches: finite logits, state
                   unchanged, no kernel launch;
  6. scatter       B4 (bf16 + f32 streams) and B2 ([R, 3, 128] f32)
     kernels       against their plain versions at the 4M-cap batch's N
                   and n_valid: bit-exact, rows outside the live prefix
                   untouched; CUDA-event times, the byte bound and the
                   index_copy_ yardstick;
  7. capacity      build the uncut bf16 + row-wise Adagrad model, B3
                   against its plain version at its batch's N and
                   n_valid; the split kernel (apply_split_rows) against
                   its plain version on a CHECK_ROWS-row bf16 table at
                   the same N and n_valid, bit-exact (also with a
                   schedule, round only and at dim 50), timed beside its
                   byte bound; 8 + 3 training steps (B3 and the split
                   kernel once per step, no other kernel, step counter 11, peak device memory
                   under 72 GB), 3 scoring batches (finite logits, table
                   and accumulator unchanged, no launch);
  8. capacity      a small capacity-mode DLRM, 3 steps on the card and on
     small         the CPU (bf16 rows within one ulp per step);
  9. short paths   bf16 + Adagrad (B4 and the round-only split kernel
                   once per step) and f32 + Adam (B2
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
 15. coo           one full-width batch of the packed slice (2,818,048
                   ids) through the device COO transform (in
                   set_sync_debug_mode("error")), the numpy path and the
                   C++ engine: every array and stat bit-exact; then a
                   weighted mean / sum / sqrtn stack at valences 100,
                   27, 12 and a shared 1-D feature, batch 16,384: the
                   three bit-exact, divisors and gains included;
 16. mlperf        the ml_perf entry point, main("full_criteo") with each
                   vocabulary capped at 4M rows: 70 steps with device
                   preprocessing, main's chained-step window
                   (honest_timing, a device step reported), the dummy
                   eval (B1 once per step, no other kernel); 16 steps
                   in host mode (C++ engine, 4 loader
                   threads) from the config's 8,192 / 4,096, which its
                   training passes grow (no id dropped); both modes'
                   losses over the same 3 batches from the same weights
                   (host mode grown, every B1 call of it held to the
                   plain version), and the host syncs of one
                   device-mode step;
 17. auc           main("smoke_test", num_steps=300,
                   device_preprocessing=True): AUC > 0.60;
 17b. mlperf       8 full-width Criteo-schema files (12 protos of 4,096
      files        samples each, 393,216 samples, ~0.7 GB, learnable)
                   and a validation file, written with the port's
                   writer: the reader alone (a fresh dataset's first
                   pass: file 1 generic, every later file fixed; each
                   file's fixed arrays equal to its generic ones; the
                   fixed and the generic path at 1, 2 and 4 prefetch
                   workers read every sample); main("full_criteo",
                   file_pattern=...) at the 4M cap with device
                   preprocessing twice, B1 once per step and no other
                   kernel: 3 steps with every B1 call held to its plain
                   version at phase 2's bound; 70 steps; main("smoke_test") from
                   small learnable files, 300 steps: AUC > 0.60. No
                   fallback to the Python reader or dummy batches; the
                   files are deleted;
 18. retrieval     a small TwoTower with tower MLPs, 3 DenseAdagrad steps
     small         on the card and on the CPU (losses and parameters
                   within 1e-5); a cosine compute_score subclass over
                   300,000 candidates takes the direct path under "auto"
                   and raises with an explicit chunk_size;
 19. retrieval     8 steps on one fixed batch (loss falls), 3 fresh; the
     train         tutorial loss (RemoveAccidentalHits,
                   HardNegativeMining(255), SamplingProbabilityCorrection)
                   3 steps, finite; peak memory;
 20. retrieval     make_retrieval(k=10) over the 1M candidates: 3 batches
     serve         of 256, chunked exact and recall_target=0.95 ids equal
                   a direct top-k; brute force at 10M x 128 (5.1 GB);
                   KMeansRetrieval (default clusters, 16
                   probes) over a 1M x 128 Gaussian mixture of 1,000
                   centres in f32 and int8 + reorder: peak memory,
                   recall@10 > 0.8; full probing at 100k equals brute
                   force;
 21. ranking       the 5 losses and 6 metrics on [1024, 100] lists, card
                   against CPU within 1e-5 relative; the listwise path
                   with ListMLE and PairwiseLogistic, 8 steps each (loss
                   falls), NDCG@10, MAP, MRR on 3 held-out batches in
                   [0, 1]; BasicRanking 8 steps of mse_loss (loss falls).
                   No kernel launches in phases 18-21.
 22. serving       small DLRMs (f32 + Adagrad; capacity mode) card and
     small         CPU from one state: freeze() and the int8, int8_packed
                   and int8_fused freezes, tables, q, scale and packed
                   words bit-exact card vs CPU, activations within 1e-6
                   of their largest; Ragged, padded and sparse requests
                   equal; serving_copy equals the trained layer (the
                   construction-order and the sorted forward), holds no
                   slot and shares no storage; 3 steps on Ragged batches
                   narrower than the valence (sorted forward) card vs CPU
                   within phases 3 and 8's bounds;
 23. dlrm serve    (after phase 5, on the trained packed model) freeze in
                   f32, int8, int8_packed, int8_fused; 3 request batches
                   of 16,384 and 3 of 512 (large features Ragged, lengths
                   uniform in [1, multi-hot size], padded to the
                   valence), eager and through aot_compile: finite
                   logits, frozen f32 within 5e-3 of the model's scoring
                   logits, int8 layouts equal bit for bit and within the
                   int8 bound (absmax/254 per id) of f32, the graph equal
                   to eager, the eager path free of host syncs, no kernel
                   launch; frozen bytes, peak memory; serving_copy
                   (state bytes against the training state; the
                   construction-order and the sorted forward equal to
                   the trained layer);
 24. capacity      (after phase 7) the bf16 model's scoring logits on 3
     serve         Ragged batches of 16,384, freeze(quantize="int8") of
                   the 204,102,450 table rows beside the training state
                   (peak under the card's memory), the state freed, the
                   3 batches served from the int8 tables: finite, within
                   the int8 bound of the bf16 model's activations;
                   serving peak memory;
 25. export        export_fn / import_fn of an int8-frozen small DLRM and
                   of a retrieval service (MLP query tower, top-10
                   BruteForceRetrieval over 100,000 x 128): the imported
                   output equals the eager one on the card; artifact
                   bytes. No kernel launches in phases 23-25.
 26. gru4rec       a small GRU4Rec (200 items, dim 32), 3 Adam steps on
     small         the card and on the CPU from one state (losses and
                   parameters within 1e-5); a GRU whose mask has holes,
                   card vs CPU within 1e-6;
 27. gru4rec       GRU4Rec(3706, 128) over histories of 10 (a quarter
                   left-padded), Markov sessions (branching 12, noise
                   0.2), Adam 0.01, batch 4,096, through Trainer.fit
                   (prefetch 2, validation 1 - recall@10, checkpoints,
                   metrics log; 4 epochs of 8 steps, epoch loss falls);
                   3 more steps in memory against a fresh model restored
                   from `last` (losses within 1e-6 relative); the host
                   syncs of one step; held-out recall@10 above 5x
                   popularity's; Trainer.evaluate (recall@10, NDCG@10
                   in [0, 1]); make_retrieval(k=10) over 3,707 rows,
                   batches of 1,024; checkpoint bytes. No kernel
                   launches in phases 26-27.
 28. layers        full-rank and low-rank (512) FeatureCross at width
                   3,456 (diag_scale 0.5, relu, L2 on the kernels and
                   bias) and DotInteraction over 27 x 128 (four flag
                   combinations), forward and backward card vs CPU
                   within 1e-5 of the largest value; a learning-rate
                   schedule on the packed DLRM
                   slice, 3 steps in sync-debug "error" (B1 once per
                   step and stack, each call held to its plain version
                   on the same blocks and gradients at phase 2's bound,
                   with the rate the schedule gives at the step); the
                   port's dcn (3 runs per
                   architecture) and sequential_retrieval examples;
 29. checkpoint    the ml_perf entry point: main("smoke_test", 6 steps,
                   checkpoint_every 2), then to 8 steps (the rerun logs
                   "resumed from checkpoint step 6"; its loss within
                   1e-3 of one process over the same 8 batches, its
                   step counters 8), then 24 steps with
                   do_profile (a non-empty trace); one row kernel per
                   step and stack. Then phase 28's packed 4M-cap state
                   through save_checkpoint / restore_checkpoint where the
                   disk holds it (bytes, the device memory restore
                   adds, the state back bit for bit).
 30. pipelined     main("full_criteo", pipeline_embedding=True,
     mlperf        device_preprocessing=True) at the 4M cap: 70 steps and
                   main's chained-step window (B1 once per step, no
                   other kernel); then from the
                   same weights over the same 8 batches the unpipelined
                   and the pipelined step: step 0's losses equal, the
                   losses within 5e-3; the first 3 prefetches equal to a
                   gather of the same batch on the main stream taken
                   before the step (the race check) and each B1 call
                   held to its plain version at phase 2's bound; one step
                   in sync-debug "error"; the same steps held bit for
                   bit to the prefetch on the main stream;
 31. pipelined     bf16 tables + row-wise Adagrad at the 4M cap, device
     split         preprocessing: 8 steps on one batch (loss falls) and 3
                   fresh, the first 3 race-checked, every row scatter
                   and split kernel call held to its plain version, B3
                   and the split kernel once per step; the host syncs of
                   one step (none expected);
 32. examples      the six walkthrough examples on the card at their
                   default sizes (printout kept, headline gated, no
                   kernel launch); the ml_perf entry point's pipelined
                   resume (smoke_test: 6 steps with checkpoint_every 3,
                   then a rerun to 9 that logs "resumed from checkpoint
                   step 6", finite losses).
 32b. bench        the benchmark entry point (keras_rs_tpu_torch/bench.py)
                   at its default shape (batch 8,192, vocabularies 4M,
                   2M, 2,000, 500, dim 128): one untimed step each of
                   ours, of the pipelined variant and of the flagship
                   variant (the Criteo mix at the 1M cap), with every B1
                   call held to its plain version at phase 2's bound;
                   bench.main() in this process with the pipelined and
                   flagship variants (ours, dense-only, naive,
                   pipelined, flagship), B1 counted to the step and no
                   other kernel; its JSON line has every key, no error
                   field, value > 0, mfu_dense and embedding_floor_frac
                   in (0, 1], the floor at most 1.05 x embedding_ms
                   before rounding and the flagship's floor below its
                   step. Then one untimed step of the bf16 + row-wise
                   Adagrad mix with every B3 and split kernel call held
                   bit for bit, and bench.main() in that mix without
                   naive and flagship (B3 and the split kernel counted,
                   no other kernel);
 33. probe        two ranks on cuda:0 in one gloo group: each
                   collective of parallel/collectives.py on CUDA tensors
                   of the types the path gives it, checked; one that
                   gloo does not carry, or carries wrong, fails;
 34. sharded       MLPerf widths and batch 16,384 over the two ranks
     mlperf        (8,192 each): with vocabularies capped at 500k, an f32
                   dense stack, learning rate 0.05 and a D = 1 copy in
                   each rank from the same seed: the rank's device COO
                   bit-exact with the one-process transform at D = 2
                   (its send row and received column); activations and
                   logits within 1e-4 x max(1, |D = 1|); one cotangent
                   through apply_cotangents, each table element's change
                   within 1e-3 of the table's largest change plus 4 ulp
                   (1e-4 in relative L2); one training step's change of
                   the tables and of the dense parameters within 1e-2
                   in relative L2, and the loss's fall over it within
                   1e-2; comm_dtype="bfloat16" for the same steps
                   against the f32 exchange (first loss within 1e-2,
                   changes within 0.25 in relative L2 and not equal,
                   their norms and the loss's fall within 2e-2); an
                   update that changed nothing fails each of these; then
                   main("full_criteo") at the 4M cap on each rank
                   (device COO, 8 steps and main's chained-step window
                   of 2 blocks of 3 steps, B1 once per step, every B1
                   call of the 8 steps held to the plain version, the
                   window's blocks not), peak memory;
 35. sharded       bf16 + row-wise Adagrad at the 4M cap over the two
     split         ranks: 3 steps on one batch (the global loss falls),
                   B3 and the split kernel once per step on each shard,
                   B3 held to the plain scatter on a copy of the whole
                   shard, the split kernel to its plain version;
 36. sharded       a skewed batch over capacity through
     autogrow      preprocess_on_device(training=True): both ranks grow
                   alike, nothing is dropped, and the activations equal a
                   layer built with the grown capacities (COO and
                   activations bit for bit, deterministic algorithms); a
                   layer of nested feature configs returns its nest and
                   equals its from_config rebuild.

The launch counts in the kernels line are those of the main paths alone,
counted by the kernels' wrappers (a training step replayed as a CUDA
graph calls none: `wrapper_steps`): every count is set to 0 just before
a path's train-and-serve run and read just after it (B1 from the packed path and from phase 34's entry point
on both ranks, B2 from f32 + Adam, B3 from capacity mode and from phase
35 on both ranks, B4 from bf16 + Adagrad, B5-B7 from SASRec; the parts
are printed on `[launches]` lines). The ml_perf path's counts (phases 16
and 17b) and those of phases 30-32b are checked and printed on their own
lines.

Output: progress lines, then the card's name and power limit
(nvidia-smi), then one JSON line {"kernels": [...]}, then last one JSON
line {"ok": true, "device": {...}}. Without a CUDA device, or without
the package beside it, it exits with an error and prints no result.

It checks and does not measure: the step's figures are the benchmark's
(benchmark/, BENCHMARK.json). Only the kernel phases (2, 6, 7, 10) time
a kernel alone beside its plain version, for PERF.md's kernel table.

Usage (from the repository root): python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import logging
import math
import os
import re
import statistics
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

from keras_rs_tpu_torch.examples.ml_perf.configs import (
    CRITEO_MULTI_HOT_SIZES,
    CRITEO_VOCAB_SIZES,
)

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


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(loader.load, names)))
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
    from keras_rs_tpu_torch.utils.timing import HBM_BYTES_PER_S

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
    from keras_rs_tpu_torch.utils.timing import HBM_BYTES_PER_S

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


def phase_split_kernel(unique_slots, sink: int, seed: int) -> dict:
    """The split update's kernel (apply_split_rows: row-wise Adagrad and
    stochastic rounding of a bf16 table) against its plain version on a
    CHECK_ROWS-row table with its [CHECK_ROWS] accumulator, at a real
    batch's N and n_valid: the live rows of the bf16 buffer and the whole
    accumulator bit for bit, no accumulator outside the live prefix
    written; the same with a schedule read from the device, the
    round-only instance (round_split_rows) on f32 rows, and a width of 50
    (no vector loads). Times the kernel and the plain version beside the
    byte bound."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import lookup, optimizers
    from keras_rs_tpu_torch.ops import row_ops
    from keras_rs_tpu_torch.utils.timing import HBM_BYTES_PER_S

    dev = unique_slots.device
    n = unique_slots.shape[0]
    nv = int((unique_slots != sink).sum())
    if not 0 < nv < CHECK_ROWS:
        fail(f"n_valid {nv} outside (0, {CHECK_ROWS})")
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = check_indices(n, nv, g)
    table = torch.randn((CHECK_ROWS, 128), generator=g, device=dev).to(
        torch.bfloat16)
    acc0 = torch.rand(CHECK_ROWS, generator=g, device=dev) + 0.1
    grads = torch.randn((n, 128), generator=g, device=dev) * 0.01
    grads[nv:] = 0.0  # sink padding carries zero gradients
    n_valid = torch.tensor([nv], dtype=torch.int32, device=dev)
    step = torch.tensor([5.0], device=dev)
    key = lookup.ROUNDING_SEED
    opt = optimizers.RowWiseAdagrad(learning_rate=0.0034)

    def held(label, kernel, plain, live, acc=None):
        """The kernel and the plain version from the same start (each on
        its own copy of `acc`); elements differing must be 0."""
        accs = [None, None] if acc is None else [acc.clone(), acc.clone()]
        got, want = kernel(accs[0]), plain(accs[1])
        torch.cuda.synchronize()
        differ = int(((bits(got) != bits(want)) & live[:, None]).sum())
        if acc is not None:
            differ += int((bits(accs[0]) != bits(accs[1])).sum())
        if differ:
            fail(f"split kernel ({label}) differs from its plain version "
                 f"in {differ} elements")
        return got, want, accs[0]

    live = torch.arange(n, device=dev) < nv
    got, want, got_acc = held(
        "row-wise Adagrad",
        lambda a: row_ops.apply_split_rows(table, a, idx, grads, step, opt,
                                           n_valid, key),
        lambda a: row_ops.apply_split_rows_reference(
            table, a, idx, grads, step, opt, n_valid, key), live, acc0)
    err = (got[:nv].float() - want[:nv].float()).abs().max().item()
    touched = torch.zeros(CHECK_ROWS, dtype=torch.bool, device=dev)
    touched[idx[:nv].long()] = True
    changed = got_acc != acc0
    if bool(changed[~touched].any()):
        fail("split kernel wrote accumulators outside the live prefix")
    if not bool(changed[touched].all()):
        fail("split kernel left live accumulators unchanged")
    del got, want, got_acc, changed, touched
    sched = optimizers.RowWiseAdagrad(learning_rate=lr_schedule)
    held("schedule",
         lambda a: row_ops.apply_split_rows(table, a, idx, grads, step,
                                            sched, n_valid, key),
         lambda a: row_ops.apply_split_rows_reference(
             table, a, idx, grads, step, sched, n_valid, key), live, acc0)
    rows = torch.randn((n, 128), generator=g, device=dev)
    held("round only",
         lambda _: row_ops.round_split_rows(rows, idx, step, n_valid, key),
         lambda _: row_ops.round_split_rows_reference(rows, idx, step,
                                                      n_valid, key), live)
    del rows
    t50 = torch.randn((4096, 50), generator=g, device=dev).to(torch.bfloat16)
    i50 = torch.randperm(4096, generator=g, device=dev)[:1000].to(
        torch.int32)
    g50 = torch.randn((1000, 50), generator=g, device=dev)
    nv50 = torch.tensor([700], dtype=torch.int32, device=dev)
    held("dim 50",
         lambda a: row_ops.apply_split_rows(t50, a, i50, g50, step, opt,
                                            nv50, key),
         lambda a: row_ops.apply_split_rows_reference(
             t50, a, i50, g50, step, opt, nv50, key),
         torch.arange(1000, device=dev) < 700,
         torch.rand(4096, generator=g, device=dev) + 0.1)
    del t50, i50, g50

    acc = acc0.clone()
    ms, plain_ms, times = time_in_turns(
        lambda: row_ops.apply_split_rows(table, acc, idx, grads, step, opt,
                                         n_valid, key),
        lambda: row_ops.apply_split_rows_reference(
            table, acc, idx, grads, step, opt, n_valid, key))
    # Bytes: each live row's f32 gradient, bf16 row read and bf16 row
    # written, accumulator read and written, and index.
    moved = nv * (128 * 4 + 2 * 128 * 2 + 8 + 4)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] apply_split_rows N={n} n_valid={nv} rows={CHECK_ROWS}: "
        f"max_abs_err {err!r} (bit-exact, also with a schedule, round "
        f"only and at dim 50); kernel {ms!r} ms ({moved / ms / 1e6:.1f} "
        f"GB/s of {moved / 1e9:.3f} GB), plain {plain_ms!r} ms, bound "
        f"{bound_ms!r} ms (bytes, {bound_ms / ms:.1%} of it); runs {times}")
    del table, acc0, acc, grads
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


SMALL_BATCH = 64  # the small card-vs-CPU models


def small_config(**overrides):
    """The small DLRM of the card-vs-CPU phases: two stacked features
    (vocab 2000 and 1500, valence 3 and 2), two small ones, f32 dense
    layers."""
    from keras_rs_tpu_torch.models.dlrm import DLRMConfig

    B = SMALL_BATCH
    return DLRMConfig(
        vocab_sizes=[2000, 1500, 50, 30], multi_hot_sizes=[3, 2, 1, 2],
        bottom_mlp=(64, 128), top_mlp=(64, 32, 1), num_dcn_layers=2,
        dcn_projection_dim=32, embedding_threshold=1000,
        max_ids_per_partition=B * 5, max_unique_ids_per_partition=B * 5,
        learning_rate=0.05, global_batch_size=B, table_placement="sharded",
        compute_dtype=None, dense_output_dtype="float32", **overrides,
    )


def phase_small_reference(label: str, bound: str, expect: dict,
                          narrow: bool = False, **overrides) -> None:
    """The port on the card against the port on the CPU (whose plain
    paths the CPU tests hold to the JAX package): a small model with f32
    dense layers, identical parameters and state, 3 steps; the card's
    kernel launches must be `expect`. With `narrow`, the stacked features
    come as Ragged rows shorter than their valence, so the steps take the
    lookup's sorted forward.

    `bound` "f32": losses and tables within 1e-5 (sums in another
    order). "bf16 tables": the card and the CPU round the bf16 rows
    stochastically with different random bits, so tables within one bf16
    ulp per step taken (3) plus 1e-4 absolute (an element whose gradient
    nearly cancels takes an update that the f32 differences change in
    relative terms), losses within 1e-4, as the CPU tests hold the port
    to the JAX package in this mode."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2, bce_loss
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    B = SMALL_BATCH
    cfg = small_config(**overrides)

    def batch(s):
        raw = criteo_like_batch(B, vocab_sizes=cfg.vocab_sizes,
                                multi_hot_sizes=cfg.multi_hot_sizes, seed=s)
        if narrow:
            raw = ragged_requests(raw, np.random.default_rng(s), [0, 1],
                                  narrow=True)
        return raw

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
            losses[dev] = [float(step(m.preprocess(batch(s))))
                           for s in (0, 1, 0)]
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
               "scatter_rows", "_scatter_rows_multi", "apply_split_rows",
               "round_split_rows")


def reset_launch_counts() -> None:
    """Sets every kernel's launch count to 0, and StepGraph's totals."""
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops
    from keras_rs_tpu_torch.training.train_state import StepGraph

    for name in ROW_KERNELS:
        getattr(row_ops, name).launches = 0
    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0
    StepGraph.totals.clear()


def replays() -> int:
    """Training steps replayed as a CUDA graph since reset_launch_counts()
    (training/train_state.StepGraph), the capturing calls' included."""
    from keras_rs_tpu_torch.training.train_state import StepGraph

    return StepGraph.totals["replays"]


def wrapper_steps(steps: int) -> int:
    """Of `steps` training-step calls since reset_launch_counts(), those
    that ran the step's Python, and with it each kernel's wrapper, which
    counts its launches: all but the replays of a captured graph, whose
    kernels the graph launches. A capturing call runs both."""
    from keras_rs_tpu_torch.training.train_state import StepGraph

    totals = StepGraph.totals
    return steps - (totals["replays"] - totals["captures"])


def launch_counts() -> dict[str, int]:
    from keras_rs_tpu_torch.ops import flash_attention as fa
    from keras_rs_tpu_torch.ops import row_ops

    counts = {name: getattr(row_ops, name).launches for name in ROW_KERNELS}
    counts.update({name: getattr(fa, name).launches
                   for name in FLASH_KERNELS})
    return counts


def dlrm_batch(cfg, s: int, batch: int | None = None) -> dict:
    """A raw batch of `cfg`'s features (of `batch` rows, default the
    configured global batch) from seed `s`."""
    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch

    return criteo_like_batch(batch or cfg.global_batch_size,
                             vocab_sizes=cfg.vocab_sizes,
                             multi_hot_sizes=cfg.multi_hot_sizes, seed=s)


def build_dlrm(label: str, cfg, seed: int):
    """The model on the card, with its state sizes."""
    import torch

    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2

    dev = torch.device("cuda", 0)
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev,
    )
    emb = model.embedding_layer
    parts, nbytes = [], 0
    for i in range(len(emb.stacks)):
        state = emb.stack_state(i)
        for name, t in [("table", state["table"]),
                        *state.get("slots", {}).items()]:
            parts.append(f"{name} {tuple(t.shape)} "
                         f"{str(t.dtype).split('.')[-1]}")
            nbytes += t.numel() * t.element_size()
    log(f"[{label} model] built: {len(model.large_idx)} "
        f"stacked tables in {len(emb.stacks)} stack(s), state {parts} = "
        f"{nbytes / 1e9:.2f} GB, {len(model.small_idx)} small tables, "
        f"{sum(p.numel() for p in model.parameters())} dense parameters; "
        f"device memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} "
        "GB")
    return model


def drive_dlrm(label: str, model, cfg, seed: int, fixed, expect: dict,
               fixed_steps: int, fresh_steps: int, score_batches: int
               ) -> dict:
    """The main path of one DLRM configuration: `fixed_steps` training
    steps on the preprocessed batch `fixed` (the loss must fall), then
    `fresh_steps` on fresh batches, then `score_batches` scoring batches
    under no_grad (finite logits, state unchanged, no kernel launch).
    Every launch count is set to 0 just before and read just after: each
    kernel in `expect` must launch that many times per step and stack
    through its wrapper (in the calls that ran the step's Python: the
    first, the warm-up and the capturing call of the step's CUDA graph),
    every other kernel never; every later step must replay the graph, and
    the stacks' step counters, which the update kernels' steps advance on
    the card, must count every step. Returns the counts, the replays and
    the peak memory."""
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
    losses = []
    for _ in range(fixed_steps):
        losses.append(float(step(fixed)))
    log(f"[{label} train] fixed batch losses {losses}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses[0]} -> {losses[-1]}")
    for s in range(fresh_steps):
        losses.append(float(step(model.preprocess(
            dlrm_batch(cfg, seed + 1 + s)))))
    if fresh_steps:
        log(f"[{label} train] fresh batch losses {losses[fixed_steps:]}")
    if not all(map(math.isfinite, losses)):
        fail(f"{label}: non-finite loss on fresh batches")
    n_steps = fixed_steps + fresh_steps
    trained = launch_counts()
    ran = wrapper_steps(n_steps)
    want = {name: expect.get(name, 0) * ran * n_stacks
            for name in trained}
    if trained != want:
        fail(f"{label}: launches {trained} in the {ran} of {n_steps} steps "
             f"that ran their wrappers, {n_stacks} stack(s), expected "
             f"{want}")
    replayed = replays()
    if replayed != max(n_steps - 2, 0):
        fail(f"{label}: {replayed} of {n_steps} steps replayed the step's "
             f"graph, expected all but the first two")
    steps_done = [float(emb.stack_state(i)["step"]) for i in range(n_stacks)]
    if steps_done != [float(n_steps)] * n_stacks:
        fail(f"{label}: stack step counters {steps_done}, expected "
             f"{n_steps}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label} train] peak device memory {peak_gb:.2f} GB; launches "
        f"{ {k: v for k, v in trained.items() if v} } in {ran} steps and "
        f"{replayed} graph replays; step counters {steps_done}")

    sums = [state_checksum(emb.stack_state(i)) for i in range(n_stacks)]
    with torch.no_grad():
        for s in range(score_batches):
            logits = model(model.preprocess(dlrm_batch(cfg, seed + 100 + s)))
            if tuple(logits.shape) != (B,):
                fail(f"{label}: logits shape {tuple(logits.shape)}")
            if not bool(torch.isfinite(logits).all()):
                fail(f"{label}: non-finite logits")
    if [state_checksum(emb.stack_state(i))
            for i in range(n_stacks)] != sums:
        fail(f"{label}: scoring changed the embedding state")
    if launch_counts() != trained:
        fail(f"{label}: scoring launched a kernel")
    log(f"[{label} score] {score_batches} batches of {B}: finite logits; "
        "state checksums (table and slots) unchanged")
    del opt, step
    return {"launches": trained, "replays": replayed, "peak_gb": peak_gb}


def run_dlrm(seed: int) -> tuple[dict, object, int]:
    """The packed DLRM path (f32 tables, Adagrad, 4M-row cap, kernel B1);
    returns B1's kernel entry and the fixed batch's unique_slots (on the
    CPU) with its sink."""
    import torch

    cfg = slice_config()
    model = build_dlrm("dlrm", cfg, seed)
    fixed = model.preprocess(dlrm_batch(cfg, seed))
    stack = model.embedding_layer.stacks[0]
    coo = fixed["large_pre"]["sharded"][stack.name]
    kernel = phase_kernel(coo["unique_slots"], stack.sink_slot, seed)
    phase_small_reference("f32", "f32", {"apply_scatter_row_blocks": 3})
    run = drive_dlrm(
        "dlrm", model, cfg, seed, fixed, {"apply_scatter_row_blocks": 1},
        FIXED_STEPS, FRESH_STEPS, SCORE_BATCHES)
    phase_dlrm_serve(model, cfg, seed)
    slots = coo["unique_slots"].cpu()
    del model, fixed, coo
    torch.cuda.empty_cache()
    return {
        "name": "apply_scatter_row_blocks",
        "route": "cuda",
        "source": "keras_rs_tpu_torch/csrc/row_ops.cu",
        "replaces": "keras_rs_tpu/ops/row_ops.py:472",
        "launches": run["launches"]["apply_scatter_row_blocks"],
        **kernel,
    }, slots, stack.sink_slot


def run_capacity(seed: int) -> tuple[dict, dict]:
    """Capacity mode on the uncut Criteo vocabulary: bf16 tables with
    row-wise Adagrad in one 204,102,451-row stack; B3 and the split
    update's kernel checked at this batch's N and n_valid, then trained
    and scored. Returns B3's entry and the split kernel's."""
    import torch

    cfg = slice_config(vocab_cap=None, table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad")
    model = build_dlrm("capacity", cfg, seed)
    (stack,) = model.embedding_layer.stacks
    if stack.global_rows != CAPACITY_ROWS or stack.packed_state:
        fail(f"capacity stack: {stack.global_rows} rows, packed "
             f"{stack.packed_state}; expected {CAPACITY_ROWS}, split")
    fixed = model.preprocess(dlrm_batch(cfg, seed))
    coo = fixed["large_pre"]["sharded"][stack.name]
    kernel = phase_scatter_kernel(
        "scatter_rows", [(torch.bfloat16, (128,))], coo["unique_slots"],
        stack.sink_slot, seed)
    split = phase_split_kernel(coo["unique_slots"], stack.sink_slot, seed)
    run = drive_dlrm(
        "capacity", model, cfg, seed, fixed,
        {"scatter_rows": 1, "apply_split_rows": 1},
        FIXED_STEPS, FRESH_STEPS, SCORE_BATCHES)
    if run["peak_gb"] >= PEAK_LIMIT_GB:
        fail(f"capacity: peak device memory {run['peak_gb']:.2f} GB >= "
             f"{PEAK_LIMIT_GB}")
    phase_capacity_serve(model, cfg, seed)
    del model, fixed, coo
    torch.cuda.empty_cache()
    entry = dict(route="cuda", source="keras_rs_tpu_torch/csrc/row_ops.cu")
    return ({"name": "scatter_rows", **entry,
             "replaces": "keras_rs_tpu/ops/row_ops.py:56",
             "launches": run["launches"]["scatter_rows"], **kernel},
            {"name": "apply_split_rows", **entry,
             "replaces": "none (XLA ops, keras_rs_tpu/layers/embedding/"
                         "lookup.py:448-523)",
             "launches": run["launches"]["apply_split_rows"], **split})


def run_short(label: str, seed: int, slots_4m, expect: dict,
              **overrides) -> dict:
    """A short path at the 4M-row cap: 3 steps on one batch, 1 scoring
    batch. Its fixed batch's unique_slots must equal the packed path's
    (same cap, same seed), so the kernel checks made with those held the
    kernel at this path's N and n_valid. Returns the launch counts."""
    import torch

    cfg = slice_config(**overrides)
    model = build_dlrm(label, cfg, seed)
    fixed = model.preprocess(dlrm_batch(cfg, seed))
    (stack,) = model.embedding_layer.stacks
    coo = fixed["large_pre"]["sharded"][stack.name]
    if not torch.equal(coo["unique_slots"].cpu(), slots_4m):
        fail(f"{label}: unique_slots differ from the packed path's")
    run = drive_dlrm(label, model, cfg, seed, fixed, expect, SHORT_STEPS, 0,
                     1)
    del model, fixed, coo
    torch.cuda.empty_cache()
    return run["launches"]


def run_row_scatter(seed: int, slots_4m, sink_4m) -> list:
    """B4 and B2 at the 4M-cap batch's N and n_valid, the capacity path
    (B3 and the split kernel), the two short paths that launch B4 (with
    the split kernel's round-only instance) and B2, and the small
    capacity-mode model against the CPU. Returns the entries of B2, B3,
    B4 and the split kernel."""
    import torch

    multi = phase_scatter_kernel(
        "_scatter_rows_multi",
        [(torch.bfloat16, (128,)), (torch.float32, (128,))],
        slots_4m.cuda(), sink_4m, seed + 1)
    blocks = phase_scatter_kernel(
        "scatter_row_blocks", [(torch.float32, (3, 128))],
        slots_4m.cuda(), sink_4m, seed + 2)
    b3, split = run_capacity(seed)
    phase_small_reference("capacity", "bf16 tables",
                          {"scatter_rows": 3, "apply_split_rows": 3},
                          table_dtype="bfloat16",
                          embedding_optimizer="rowwise_adagrad")
    b4_launches = run_short("bf16 adagrad", seed, slots_4m,
                            {"_scatter_rows_multi": 1,
                             "round_split_rows": 1},
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
        split,
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

    from keras_rs_tpu_torch.utils.timing import HBM_BYTES_PER_S, PEAK_FLOPS

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


def run_sasrec(seed: int) -> dict:
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
    losses = []
    for _ in range(FIXED_STEPS):
        losses.append(float(trainer.step(fixed)))
    log(f"[sasrec train] fixed batch losses {losses}")
    if not all(map(math.isfinite, losses)):
        fail("SASRec: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"SASRec loss did not fall: {losses[0]} -> {losses[-1]}")
    for s in range(FRESH_STEPS):
        losses.append(float(trainer.step(
            sasrec_batch(SAS_BATCH, SAS_T, seed + 1 + s))))
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
    log(f"[sasrec train] peak device memory {peak_gb:.2f} GB; launches "
        f"{trained}")

    params = [p.detach().clone() for p in model.parameters()]
    retrieval = model.make_retrieval(k=SAS_TOP_K)
    first = None
    with torch.no_grad():
        for s in range(SCORE_BATCHES):
            hist = torch.from_numpy(sasrec_batch(
                SAS_SERVE_USERS, SAS_T, seed + 100 + s, pad="right",
            )["item_history"]).to(dev)
            user = model(hist)
            scores, ids = retrieval(user)
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
        f"users: launches {served}")

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


# --- COO preprocessing and the ml_perf entry point ------------------------


#: Steps of the ml_perf runs: device mode and host mode.
MLPERF_STEPS = 70
MLPERF_HOST_STEPS = 16
#: main's honest_timing: one warm-up block and 3 timed blocks of 20.
MLPERF_TIMING_STEPS = 4 * 20
#: The two modes' losses over the same 3 batches: equal on the first
#: step; then the segment-sum's float atomics add in another order in
#: each run, and the bf16 dense stream can round a changed value to the
#: next bf16 step, so the later losses are held to 1e-3 absolute.
MODE_LOSS_BOUND = 1e-3
AUC_GATE = 0.60


def main_results_ok(r: dict, timed: bool = False) -> bool:
    """The ml_perf main's results in range: a finite loss, an AUC in [0,
    1] and, with `timed`, a device step from its honest_timing window."""
    step = r.get("device_step_ms", 0.0) if timed else 1.0
    return (math.isfinite(r["loss"]) and 0.0 <= r["auc"] <= 1.0
            and math.isfinite(step) and step > 0)


def sync_sites(fn) -> list[str]:
    """The host syncs of fn() (set_sync_debug_mode("warn")), each as the
    innermost frame of this repository on its Python stack."""
    import traceback

    import torch

    sites, active = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        if not active or "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(str(ROOT))]
        where = frames[-1] if frames else None
        sites.append(f"{Path(where.filename).relative_to(ROOT)}:"
                     f"{where.lineno} ({where.line})" if where
                     else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        # Only fn's syncs: the first switch to "warn" in a process can
        # itself warn.
        torch.cuda.set_sync_debug_mode("warn")
        active.append(True)
        try:
            fn()
        finally:
            active.clear()
            torch.cuda.set_sync_debug_mode(0)
    return sites


def phase_coo(seed: int) -> None:
    """The device transform, the numpy path and the C++ engine on one
    full-width batch (the packed slice: 9 large features, 2,818,048 ids,
    one all-sum stack): every array and stat bit-exact, the device
    transform run in set_sync_debug_mode("error")."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import preprocessing
    from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
        preprocess_stack_device,
    )
    from keras_rs_tpu_torch.layers.embedding.stacking import build_stacks
    from keras_rs_tpu_torch.models.dlrm import large_feature_configs

    cfg = slice_config()
    (stack,) = build_stacks(list(large_feature_configs(cfg).values()), 1)
    raw = dlrm_batch(cfg, seed)
    inputs = {f.name: raw[f.name] for f in stack.features}
    n_ids = sum(v.size for v in inputs.values())
    dev_inputs = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    torch.cuda.synchronize()

    def transform():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return preprocess_stack_device(stack, dev_inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    coo, stats = transform()
    got = {k: v.cpu().numpy() for k, v in coo.arrays().items()}
    got_stats = preprocessing.InputStats(*(int(x) for x in stats))
    for backend in ("numpy", "native"):
        want, want_stats = preprocessing.preprocess_stack(
            stack, inputs, backend=backend)
        if got.keys() != want.arrays().keys():
            fail(f"coo: device arrays {sorted(got)} vs {backend} "
                 f"{sorted(want.arrays())}")
        for k, a in want.arrays().items():
            if got[k].dtype != a.dtype or not np.array_equal(got[k], a):
                fail(f"coo: device {k} differs from {backend}")
        if got_stats != want_stats:
            fail(f"coo: device stats {got_stats} vs {backend} "
                 f"{want_stats}")
    log(f"[coo] {n_ids} ids in {stack.num_features} features, stack "
        f"{stack.name} ({stack.global_rows} rows, C = U = "
        f"{stack.max_ids_per_partition}): device, numpy and C++ arrays "
        f"and stats bit-exact ({', '.join(sorted(got))}; {got_stats})")
    del coo, dev_inputs
    torch.cuda.empty_cache()
    coo_combiners(seed)


#: Phase 15's mean / sqrtn stack: the CPU test's stack
#: (tests/test_torch_native_preprocess.py::make_stack: a mean, a sum and
#: a sqrtn table and a 1-D feature sharing the first) at the largest
#: Criteo valences and vocabularies (capped at 4M), batch 16,384.
COO_COMBINER_TABLES = (("mean", 4_000_000, 100), ("sum", 590_152, 27),
                       ("sqrtn", 3_067_956, 12))


def combiner_batch(seed: int):
    """COO_COMBINER_TABLES' stack and one weighted batch of it, invalid
    ids and zero weights among the entries: (stack, inputs, weights), the
    batch as host arrays."""
    from keras_rs_tpu_torch.layers.embedding.config import (
        FeatureConfig,
        TableConfig,
    )
    from keras_rs_tpu_torch.layers.embedding.stacking import build_stacks

    cap = BATCH * (sum(L for _, _, L in COO_COMBINER_TABLES) + 1)
    tables = [TableConfig(f"c{i}", vocab, 128, combiner=combiner,
                          max_ids_per_partition=cap,
                          max_unique_ids_per_partition=cap)
              for i, (combiner, vocab, _) in enumerate(COO_COMBINER_TABLES)]
    fcs = [FeatureConfig(f"c{i}", t, (BATCH, L), (BATCH, 128))
           for i, (t, (_, _, L)) in enumerate(zip(tables,
                                                  COO_COMBINER_TABLES))]
    fcs.append(FeatureConfig("c_shared", tables[0], (BATCH,), (BATCH, 128)))
    (stack,) = build_stacks(fcs, 1)
    rng = np.random.default_rng(seed + 15)
    inputs, weights = {}, {}
    for f in stack.features:
        vocab = stack.table_spec(f.table_name).vocabulary_size
        shape = (BATCH, f.valence) if f.valence > 1 else (BATCH,)
        inputs[f.name] = rng.integers(-2, vocab + 2, size=shape)
        w = rng.uniform(0.1, 3.0, size=shape).astype(np.float32)
        w[rng.random(shape) < 0.1] = 0.0
        weights[f.name] = w
    return stack, inputs, weights


def coo_combiners(seed: int) -> None:
    """combiner_batch(seed) (a weighted mean / sum / sqrtn stack) through
    the device transform in set_sync_debug_mode("error"), the numpy path
    and the C++ engine: every array and stat bit-exact, the divisors and
    the gains they divide included (the device sums each segment in
    numpy's order, without atomics)."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import preprocessing
    from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
        preprocess_stack_device,
    )

    stack, inputs, weights = combiner_batch(seed)
    n_ids = sum(v.size for v in inputs.values())
    dev_in = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    dev_w = {k: torch.from_numpy(v).cuda() for k, v in weights.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coo, stats = preprocess_stack_device(stack, dev_in, dev_w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: v.cpu().numpy() for k, v in coo.arrays().items()}
    got_stats = preprocessing.InputStats(*(int(x) for x in stats))
    for backend in ("numpy", "native"):
        want, want_stats = preprocessing.preprocess_stack(
            stack, inputs, weights, backend=backend)
        if got.keys() != want.arrays().keys():
            fail(f"coo combiners: device arrays {sorted(got)} vs {backend} "
                 f"{sorted(want.arrays())}")
        for k, a in want.arrays().items():
            if got[k].dtype != a.dtype or not np.array_equal(got[k], a):
                n_bad = int((got[k] != a).sum()) if got[k].shape == a.shape \
                    else "shape"
                fail(f"coo combiners: device {k} differs from {backend} "
                     f"({n_bad} elements)")
        if got_stats != want_stats:
            fail(f"coo combiners: device stats {got_stats} vs {backend} "
                 f"{want_stats}")
    if (got["divisors"] == 1.0).all():
        fail("coo combiners: every divisor is 1: no mean or sqrtn segment")
    log(f"[coo] mean / sum / sqrtn stack {stack.name}, {n_ids} ids "
        f"(valences {[L for _, _, L in COO_COMBINER_TABLES]} and a shared "
        f"1-D feature, weighted, invalid ids): device, numpy and C++ "
        f"arrays and stats bit-exact, divisors and gains included "
        f"({got_stats})")
    del coo, dev_in, dev_w
    torch.cuda.empty_cache()


def run_mlperf(seed: int) -> None:
    """The port's ml_perf `main` at full width (the MLPerf DLRM-DCNv2,
    each vocabulary capped at 4M rows, packed f32 + Adagrad state, batch
    16,384), device preprocessing, learnable dummy batches: MLPERF_STEPS
    steps, main's chained-step window (honest_timing), the dummy eval. B1
    must launch once per step and no other kernel. Then host mode (C++
    engine, 4 loader threads) for MLPERF_HOST_STEPS steps, which starts
    from the config's capacities (8,192 / 4,096) and grows them through
    the model's `preprocess_host(batch, training=True)`: it prints the
    grown capacities main returns and fails on a dropped id or on
    capacities that did not grow to hold a batch; then the two modes'
    losses over the same 3 batches from the same weights (the host
    model, too, starts from the config's capacities and grows them in
    its first `preprocess(batch, training=True)`; each of its B1 calls,
    at the grown U, held to the plain version), with the syncs of one
    device-mode step counted."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    capped = [min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES]
    dev = torch.device("cuda", 0)

    def drive(label, steps, calls, **overrides):
        """main for `steps` steps, `calls` calls of its step in all; B1
        once per call that ran the step's Python, no other kernel."""
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        r = mlperf.main("full_criteo", device=dev, num_steps=steps,
                        vocab_sizes=capped, **overrides)
        counts = launch_counts()
        expect_b1 = wrapper_steps(calls)
        want = {k: expect_b1 if k == "apply_scatter_row_blocks" else 0
                for k in counts}
        if counts != want:
            fail(f"mlperf {label}: launches {counts}, expected {want} "
                 f"({calls} steps, {replays()} graph replays)")
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not main_results_ok(r, overrides.get("honest_timing", False)):
            fail(f"mlperf {label}: results {r}")
        log(f"[mlperf {label}] results {r}; peak device memory "
            f"{peak:.2f} GB; B1 launches {expect_b1} in {calls} steps, "
            f"{replays()} graph replays")
        torch.cuda.empty_cache()
        return r

    drive("device", MLPERF_STEPS, MLPERF_STEPS + MLPERF_TIMING_STEPS,
          device_preprocessing=True, honest_timing=True)
    if not replays() > MLPERF_TIMING_STEPS:
        fail(f"mlperf device: {replays()} steps replayed the step's graph "
             f"in {MLPERF_STEPS + MLPERF_TIMING_STEPS}")
    cfg = configs.full_criteo(vocab_sizes=capped)
    rh = drive("host", MLPERF_HOST_STEPS, MLPERF_HOST_STEPS,
               num_loader_threads=4)
    grown = [(name, c["max_ids_per_partition"], c["max_unique_ids_per_shard"])
             for name, c in rh["capacities"].items()]
    dropped = sum(c["dropped_ids"] for c in rh["capacities"].values())
    n_ids = BATCH * sum(m for v, m in zip(cfg.vocab_sizes,
                                          cfg.multi_hot_sizes)
                        if v >= cfg.embedding_threshold)
    log(f"[mlperf host] capacities grew from "
        f"{cfg.max_ids_per_partition:,} / "
        f"{cfg.max_unique_ids_per_partition:,} to {grown} (stack, "
        f"max_ids_per_partition, max_unique_ids_per_shard) over "
        f"{MLPERF_HOST_STEPS} steps on 4 loader threads; {n_ids:,} large "
        f"ids per batch; {dropped} ids dropped")
    if not grown or dropped or any(
            c < n_ids or u <= cfg.max_unique_ids_per_partition
            for _, c, u in grown):
        fail(f"mlperf host: capacities {grown} for {n_ids} ids per batch, "
             f"{dropped} ids dropped")

    source = CriteoDataset(
        None, global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(3, seed=seed)
    batches = [next(source) for _ in range(3)]
    losses = {}
    for device_preprocessing in (True, False):
        model = mlperf.build_model(cfg, dev,
                                   grow=not device_preprocessing)
        step = make_train_step(
            model, mlperf.make_loss_fn(device_preprocessing),
            DenseAdagrad(model.parameters(), cfg.learning_rate))
        if device_preprocessing:
            def whole_step(b, model=model, step=step):
                return step(model.to_device(b))

            out = []
            syncs = len(sync_sites(
                lambda: out.append(whole_step(batches[0]))))
            log(f"[mlperf syncs] one device-mode step (the copy of the "
                f"raw batch, the transform, forward, backward, both "
                f"optimizers): {syncs} host syncs")
            losses[True] = [float(out[0])] + [
                float(whole_step(b)) for b in batches[1:]]
        else:
            def whole_step(b, model=model, step=step):
                return step(model.preprocess(b, training=True))

            with b1_held_to_plain() as held:
                losses[False] = [float(whole_step(b)) for b in batches]
            host_caps = [(st.max_ids_per_partition,
                          st.max_unique_ids_per_shard)
                         for st in model.embedding_layer.stacks]
        del model, step, whole_step
        torch.cuda.empty_cache()
    if len(held) != len(batches) * len(host_caps) or any(
            bool(h["bad"]) for h in held):
        fail(f"mlperf host: {len(held)} B1 calls of the grown host model, "
             f"errors against the plain version "
             f"{[float(h['err']) for h in held]}")
    log(f"[mlperf modes] the host model grew from the config's "
        f"capacities to {host_caps}; its {len(held)} B1 calls held to the "
        f"plain version: max_abs_err {[float(h['err']) for h in held]} "
        f"over {[int(h['n_valid']) for h in held]} live rows of U = "
        f"{[h['rows'] for h in held]}")
    diff = [abs(a - b) for a, b in zip(losses[True], losses[False])]
    log(f"[mlperf modes] losses device {losses[True]} host "
        f"{losses[False]}: differences {diff} (bound {MODE_LOSS_BOUND})")
    if diff[0] != 0.0 or max(diff) > MODE_LOSS_BOUND:
        fail(f"mlperf: device and host modes disagree: {diff}")


def phase_auc() -> None:
    """`main("smoke_test", num_steps=300, device_preprocessing=True)` on
    the card: the learnable dummy batches must reach AUC > 0.60."""
    import torch

    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    r = mlperf.main("smoke_test", device=torch.device("cuda", 0),
                    num_steps=300, device_preprocessing=True)
    log(f"[auc] smoke_test, 300 steps, device preprocessing: {r}")
    if not r["auc"] > AUC_GATE:
        fail(f"auc {r['auc']} <= {AUC_GATE}")


#: Phase 17b: Criteo-schema TFRecord files at full width (26 features,
#: 214 ids per sample, vocabularies capped at 4M), 4,096 samples per
#: proto as the reference's full-dataset files (configs/
#: v6e_8_full_dataset.py:17 packs 4,224): 8 files x 12 protos =
#: 393,216 samples = 24 batches of 16,384, ~0.7 GB; one validation file
#: of 8 protos (2 batches).
FILE_BATCH = 4096
FILE_COUNT = 8
FILE_PROTOS = 12
FILE_VAL_PROTOS = 8
FILE_STEPS = 70  # ~2.9 passes over the files
FILE_HELD_STEPS = 3  # the run whose every B1 call is held
FILE_WORKERS = (1, 2, 4)  # prefetch workers of the reader passes (main: 2)
#: The smoke config's files: 4 x 10 protos of 4,096 (160 batches of
#: 512 per pass) and a validation file of 4 protos.
SMOKE_FILE_COUNT = 4
SMOKE_FILE_PROTOS = 10
SMOKE_VAL_PROTOS = 4
FILE_MIN_FREE = 2e9  # bytes the disk must hold free before writing


@contextlib.contextmanager
def reader_paths():
    """While open, counts how the Criteo dataset reads each file: the
    fixed path's calls ("fixed") and deviations ("fixed_left"), the
    generic native parses ("generic"); the Python reader ("python") and
    a dummy draw ("dummy") fail the phase at once. Yields the counts."""
    import threading

    from keras_rs_tpu_torch.data import native_io
    from keras_rs_tpu_torch.data.criteo import CriteoDataset

    counts = {"fixed": 0, "fixed_left": 0, "generic": 0}
    lock = threading.Lock()
    fixed, generic = native_io.parse_file_fixed, native_io.parse_file_batched
    python_rows = CriteoDataset._batched_python_rows
    dummy = CriteoDataset.dummy_batches

    def counted_fixed(*args):
        res = fixed(*args)
        with lock:
            counts["fixed"] += 1
            counts["fixed_left"] += res is None
        return res

    def counted_generic(*args, **kwargs):
        with lock:
            counts["generic"] += 1
        return generic(*args, **kwargs)

    def refused(what):
        def call(*args, **kwargs):
            fail(f"mlperf files: the file path fell back to {what}")
        return call

    native_io.parse_file_fixed = counted_fixed
    native_io.parse_file_batched = counted_generic
    CriteoDataset._batched_python_rows = refused("the Python reader")
    CriteoDataset.dummy_batches = refused("dummy batches")
    try:
        yield counts
    finally:
        native_io.parse_file_fixed = fixed
        native_io.parse_file_batched = generic
        CriteoDataset._batched_python_rows = python_rows
        CriteoDataset.dummy_batches = dummy


def file_dataset(pattern: str, generic: bool = False, **kw):
    """The ml_perf entry point's CriteoDataset over `pattern` at full
    width; with `generic`, one that drops the learned schema before
    every file, so every file takes the generic native path."""
    from keras_rs_tpu_torch.data.criteo import CriteoDataset

    class GenericOnly(CriteoDataset):
        def _parse_file_arrays(self, path, keys, use_native):
            self._fixed_schema = None
            return super()._parse_file_arrays(path, keys, use_native)

    cls = GenericOnly if generic else CriteoDataset
    return cls(pattern, global_batch_size=BATCH,
               vocab_sizes=[min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES],
               multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
               file_batch_size=FILE_BATCH, **kw)


def read_epoch(ds, workers: int) -> int:
    """The samples of one pass of ds.batches() with `workers` prefetch
    workers."""
    return sum(len(b["label"])
               for b in ds.batches(epochs=1, file_prefetch=workers))


def phase_reader(pattern: str, paths: list) -> None:
    """The reader alone over every file: the first pass of a fresh
    dataset at one worker (file 1 generic, every later file fixed); each
    file's fixed arrays equal to its generic arrays bit for bit; then a
    pass of the fixed and of the generic path at each of FILE_WORKERS
    prefetch workers reads every sample."""
    from keras_rs_tpu_torch.data import native_io

    fixed_ds = file_dataset(pattern)
    generic_ds = file_dataset(pattern, generic=True)
    with reader_paths() as counts:
        n = read_epoch(fixed_ds, 1)
    want = {"fixed": len(paths) - 1, "fixed_left": 0, "generic": 1}
    if counts != want or fixed_ds._fixed_schema is None:
        fail(f"mlperf files: reader paths of a first pass {counts}, "
             f"expected {want}")
    keys = fixed_ds._file_keys()
    for p in paths:
        fixed = fixed_ds._parse_file_arrays(p, keys, True)
        generic_ds._fixed_schema = None
        generic = generic_ds._parse_file_arrays(p, keys, True)
        for k in generic:
            if (fixed[k].dtype != generic[k].dtype
                    or not np.array_equal(fixed[k], generic[k])):
                fail(f"mlperf files: {Path(p).name} {k}: the fixed path's "
                     "array differs from the generic path's")
    if fixed_ds._fixed_schema is None:
        fail("mlperf files: the fixed path left its schema")
    for workers in FILE_WORKERS:
        for name, ds in (("fixed", fixed_ds), ("generic", generic_ds)):
            got = read_epoch(ds, workers)
            if got != n:
                fail(f"mlperf files: {name} pass read {got} samples, "
                     f"expected {n}")
    fixed_ds.close()
    generic_ds.close()
    log(f"[mlperf files] reader alone: {n} samples of {len(paths)} files "
        f"in every pass of the fixed and the generic path at "
        f"{FILE_WORKERS} worker(s)")
    log(f"[mlperf files] first pass of a fresh dataset: {counts} (every "
        f"file after the first took the fixed path); each file's fixed "
        f"arrays equal its generic arrays bit for bit; native reader "
        f"available: {native_io.available()}")


def run_mlperf_files(seed: int) -> None:
    """Phase 17b: the ml_perf entry point trained from Criteo-schema
    TFRecord files that it writes itself with the port's writer:
    phase_reader, then main("full_criteo") at the 4M cap with device
    preprocessing over the files (eval on a validation file) three
    twice, B1 once per step and no other kernel in each: FILE_HELD_STEPS
    steps with every B1 call held to its plain version, then FILE_STEPS
    steps. Then main("smoke_test") from small learnable files, 300 steps: AUC
    > 0.60. Nothing may fall back to the Python reader or to dummy
    batches. The files are deleted."""
    import torch

    from keras_rs_tpu_torch.data import native_io
    from keras_rs_tpu_torch.data.criteo import write_batched_criteo_files
    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    if not native_io.available():
        fail("mlperf files: the native TFRecord reader does not build")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    if free < FILE_MIN_FREE:
        fail(f"mlperf files: {free / 1e9:.2f} GB free on the disk, "
             f"{FILE_MIN_FREE / 1e9:.1f} GB needed")
    capped = [min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES]
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="mlperf_files_",
                                     dir=build) as work:
        paths = write_batched_criteo_files(
            os.path.join(work, "train"), num_files=FILE_COUNT,
            protos_per_file=FILE_PROTOS, file_batch_size=FILE_BATCH,
            vocab_sizes=capped, multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
            seed=seed, learnable=True)
        write_batched_criteo_files(
            os.path.join(work, "val"), num_files=1,
            protos_per_file=FILE_VAL_PROTOS, file_batch_size=FILE_BATCH,
            vocab_sizes=capped, multi_hot_sizes=CRITEO_MULTI_HOT_SIZES,
            seed=seed + 1, learnable=True)
        nbytes = sum(os.path.getsize(p) for p in paths)
        log(f"[mlperf files] wrote {len(paths)} files x {FILE_PROTOS} "
            f"protos x {FILE_BATCH} samples ({nbytes / 1e9:.3f} GB) and a "
            f"validation file; {free / 1e9:.1f} GB were free")
        train = os.path.join(work, "train", "train-*.tfrecord")
        val = os.path.join(work, "val", "train-*.tfrecord")
        phase_reader(train, paths)

        def drive(label, steps):
            """main from the files, launches and reader paths checked."""
            reset_launch_counts()
            with reader_paths() as used:
                r = mlperf.main(
                    "full_criteo", device=dev, num_steps=steps,
                    vocab_sizes=capped, global_batch_size=BATCH,
                    device_preprocessing=True, file_pattern=train,
                    val_file_pattern=val, file_batch_size=FILE_BATCH)
            counts = launch_counts()
            log(f"[launches] phase 17b mlperf from files, {label}: {counts} "
                f"in {steps} steps, {replays()} graph replays")
            want = {k: wrapper_steps(steps)
                    if k == "apply_scatter_row_blocks" else 0
                    for k in counts}
            if counts != want:
                fail(f"mlperf files {label}: launches {counts}, expected "
                     f"{want}")
            # The first two training files may both start before a
            # schema exists (two prefetch workers), and the final eval's
            # dataset learns its own from the validation file; every
            # other parse is a fixed one.
            if (used["fixed_left"] or used["generic"] > 3
                    or (steps > FILE_HELD_STEPS and used["fixed"] < 1)):
                fail(f"mlperf files {label}: reader paths in main {used}")
            if not main_results_ok(r):
                fail(f"mlperf files {label}: results {r}")
            log(f"[mlperf files] {label}: results {r}; reader paths {used}")

        with b1_held_to_plain() as b1_calls:
            drive("held", FILE_HELD_STEPS)
        b1 = [{k: float(v) for k, v in c.items()} for c in b1_calls]
        if len(b1) != FILE_HELD_STEPS or any(c["bad"] for c in b1):
            fail(f"mlperf files: B1 calls against the plain version: {b1}")
        log(f"[mlperf files] held: every B1 call against its plain "
            f"version {b1}")
        torch.cuda.reset_peak_memory_stats()
        drive("trained", FILE_STEPS)
        log(f"[mlperf files] trained: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        torch.cuda.empty_cache()

        smoke = configs.smoke_test()
        for sub, n_files, protos, s in (
                ("smoke", SMOKE_FILE_COUNT, SMOKE_FILE_PROTOS, seed + 2),
                ("smoke_val", 1, SMOKE_VAL_PROTOS, seed + 3)):
            write_batched_criteo_files(
                os.path.join(work, sub), num_files=n_files,
                protos_per_file=protos, file_batch_size=FILE_BATCH,
                vocab_sizes=smoke.vocab_sizes,
                multi_hot_sizes=smoke.multi_hot_sizes, seed=s,
                learnable=True)
        with reader_paths() as smoke_paths:
            rs = mlperf.main(
                "smoke_test", device=dev, num_steps=300,
                device_preprocessing=True, file_batch_size=FILE_BATCH,
                file_pattern=os.path.join(work, "smoke", "train-*"),
                val_file_pattern=os.path.join(work, "smoke_val", "train-*"))
        log(f"[mlperf files] smoke_test from files, 300 steps, device "
            f"preprocessing: {rs}; reader paths {smoke_paths}")
        if not rs["auc"] > AUC_GATE:
            fail(f"mlperf files: smoke AUC {rs['auc']} <= {AUC_GATE}")
    log("[mlperf files] the files are deleted")


# Two-tower retrieval: the 1M x 128 corpus of the repo's own retrieval
# measurement (BASELINE.md:442: 1M x 128 candidates, batch 256, k 10),
# towers (256, 128), f32, batch 4,096, Zipf(1.1) ids, Adagrad at
# examples/basic_retrieval.py's 0.2.
TT_QUERIES = 1_000_000
TT_ITEMS = 1_000_000
TT_DIM = 128
TT_UNITS = (256, 128)
TT_BATCH = 4096
TT_LR = 0.2
TT_ZIPF = 1.1
TT_HARD_NEGATIVES = 255
TT_SECOND_LOSS_STEPS = 3
SERVE_BATCH = 256
SERVE_K = 10
COSINE_N = 300_000  # above BruteForceRetrieval.DIRECT_MAX_CANDIDATES
BRUTE_N = 10_000_000  # 5.1 GB of f32 candidates
BRUTE_CHECK_ROWS = 8  # queries also held to a direct top-k at 10M
IVF_N = 1_000_000
IVF_CENTRES = 1000  # Gaussian-mixture centres of the IVF corpus
IVF_SPREAD = 0.5  # per-dimension noise around a centre of N(0, 1) dims
IVF_PROBES = 16
IVF_RECALL_GATE = 0.8  # tests/test_ann.py:49
IVF_EXACT_N = 100_000  # full-probe exactness (tests/test_ann.py:52)
IVF_EXACT_QUERIES = 32
# Listwise ranking: examples/listwise_ranking.py's path at 200k users,
# 100k items, dim 128, towers (256, 128), lists of 100, batch 1,024.
RANK_USERS = 200_000
RANK_ITEMS = 100_000
RANK_LIST = 100
RANK_BATCH = 1024
RANK_LR = 0.05
RANK_STEPS = 8
RANK_EVAL_BATCHES = 3
RANK_TOL = 1e-5  # card against CPU, relative (losses and metrics)
# BasicRanking at examples/basic_ranking.py's widths (MovieLens 100k
# users and items, dim 32, MLP (256, 64, 1), Adam 3e-3, batch 512).
BR_USERS = 943
BR_ITEMS = 1682
BR_BATCH = 512
BR_LR = 3e-3


def zipf_ids(rng, n: int, size: int, perm) -> np.ndarray:
    """`size` ids of a Zipf(TT_ZIPF) law over n items: rank r (from 1)
    has probability proportional to r^-1.1; `perm` maps ranks to ids."""
    p = np.arange(1, n + 1, dtype=np.float64) ** -TT_ZIPF
    return perm[rng.choice(n, size=size, p=p / p.sum())].astype(np.int64)


def two_tower_batch(rng, perms, batch: int) -> dict:
    """Zipf query and candidate ids, and each candidate's sampling
    probability: its count in the batch over the batch size."""
    q = zipf_ids(rng, len(perms[0]), batch, perms[0])
    c = zipf_ids(rng, len(perms[1]), batch, perms[1])
    _, inverse, counts = np.unique(c, return_inverse=True,
                                   return_counts=True)
    return {"query_id": q, "candidate_id": c,
            "sampling_probability": (counts[inverse] / batch).astype(
                np.float32)}


def softmax_loss(model, batch):
    from keras_rs_tpu_torch.models.two_tower import in_batch_softmax_loss

    return in_batch_softmax_loss(model, batch["query_id"],
                                 batch["candidate_id"],
                                 batch["sampling_probability"])


def tutorial_loss(model, batch):
    """keras-rs's retrieval tutorial composition: logQ correction,
    accidental-hit removal, the 255 hardest negatives, softmax CE."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval import (
        hard_negative_mining,
        remove_accidental_hits,
        sampling_probability_correction,
    )

    scores = model.in_batch_scores(batch["query_id"], batch["candidate_id"])
    labels = torch.eye(scores.shape[0], device=scores.device)
    scores = sampling_probability_correction.SamplingProbabilityCorrection()(
        scores, batch["sampling_probability"])
    scores = remove_accidental_hits.RemoveAccidentalHits()(
        scores, labels, batch["candidate_id"])
    scores, labels = hard_negative_mining.HardNegativeMining(
        TT_HARD_NEGATIVES)(scores, labels)
    return -(labels * torch.log_softmax(scores, dim=-1)).sum(-1).mean()


def step_losses(trainer, batches) -> list:
    """The losses of one trainer step per batch."""
    return [float(trainer.step(b)) for b in batches]


def check_falls(label: str, losses) -> None:
    if not all(math.isfinite(x) for x in losses) or not (
            losses[-1] < losses[0]):
        fail(f"{label}: losses {losses} are not finite or do not fall")


def relative_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def phase_retrieval_small(dev, seed: int) -> None:
    """Phase 18: a small TwoTower with tower MLPs, 3 DenseAdagrad steps on
    the card and on the CPU from the same weights (losses and parameters
    within 1e-5); a cosine-scoring BruteForceRetrieval over COSINE_N
    candidates takes the direct path under "auto" and raises with an
    explicit chunk_size."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )
    from keras_rs_tpu_torch.models.two_tower import TwoTower
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad
    from keras_rs_tpu_torch.training.trainer import Trainer

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are on: the retrieval scores must be f32 "
             "products")
    rng = np.random.default_rng(seed)
    perms = (rng.permutation(500), rng.permutation(400))
    batches = [two_tower_batch(rng, perms, 128) for _ in range(3)]
    models = {d: TwoTower(500, 400, 32, tower_units=(64, 32),
                          generator=torch.Generator(d).manual_seed(seed),
                          device=d)
              for d in ("cpu", dev)}
    models[dev].load_state_dict(models["cpu"].state_dict())
    losses = {}
    for d, m in models.items():
        trainer = Trainer(m, DenseAdagrad(m.parameters(), TT_LR),
                          softmax_loss)
        losses[d] = [float(trainer.step(b)) for b in batches]
    cpu_params = dict(models["cpu"].named_parameters())
    worst = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
                for n, p in models[dev].named_parameters())
    log(f"[retrieval small] losses card {losses[dev]} cpu {losses['cpu']}; "
        f"parameters within {worst!r} after 3 steps")
    if relative_gap(losses[dev], losses["cpu"]) > 1e-5 or worst > 1e-5:
        fail("retrieval small: card and CPU disagree")

    class Cosine(BruteForceRetrieval):
        def compute_score(self, q, c):
            return torch.matmul(q / q.norm(dim=-1, keepdim=True),
                                (c / c.norm(dim=-1, keepdim=True)).T)

    g = torch.Generator(dev).manual_seed(seed)
    cands = torch.randn((COSINE_N, 64), generator=g, device=dev) * torch.rand(
        (COSINE_N, 1), generator=g, device=dev) * 4
    queries = torch.randn((SERVE_BATCH, 64), generator=g, device=dev)
    s, i = Cosine(cands, k=SERVE_K)(queries)  # "auto"
    ds, di = Cosine(cands, k=SERVE_K, chunk_size=None)(queries)
    _, dot_i = BruteForceRetrieval(cands, k=SERVE_K)(queries)  # chunked
    if not (torch.equal(i, di) and torch.equal(s, ds)
            and float(s.max()) <= 1.0 + 1e-5):
        fail("retrieval small: the cosine subclass left the direct path")
    try:
        Cosine(cands, k=SERVE_K, chunk_size=65536)(queries)
    except ValueError as e:
        if "dot-product" not in str(e):
            raise
    else:
        fail("retrieval small: explicit chunk_size with a custom score did "
             "not raise")
    log(f"[retrieval small] cosine subclass over {COSINE_N} candidates: "
        f"direct-path top-{SERVE_K} under 'auto' (max score "
        f"{float(s.max())!r}; the dot-product chunked path differs in "
        f"{int((dot_i != i).any(dim=1).sum())} of {SERVE_BATCH} rows), "
        "ValueError with an explicit chunk_size")


def run_retrieval(dev, seed: int) -> None:
    """Phases 19-20: the two-tower slice trained and served, brute force
    at BRUTE_N, and the k-means IVF in f32 and int8 + reorder."""
    import torch

    from keras_rs_tpu_torch.models.two_tower import TwoTower
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad
    from keras_rs_tpu_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)
    perms = (rng.permutation(TT_QUERIES), rng.permutation(TT_ITEMS))
    model = TwoTower(TT_QUERIES, TT_ITEMS, TT_DIM, tower_units=TT_UNITS,
                     generator=torch.Generator(dev).manual_seed(seed),
                     device=dev)
    trainer = Trainer(model, DenseAdagrad(model.parameters(), TT_LR),
                      softmax_loss)
    fixed = two_tower_batch(rng, perms, TT_BATCH)
    fresh = [two_tower_batch(rng, perms, TT_BATCH)
             for _ in range(FRESH_STEPS)]
    log(f"[retrieval train] batch {TT_BATCH}: "
        f"{len(np.unique(fixed['candidate_id']))} distinct candidates, "
        f"most frequent x{int(TT_BATCH * fixed['sampling_probability'].max())}"
        f" (Zipf {TT_ZIPF} over {TT_ITEMS})")
    losses = step_losses(trainer, [fixed] * FIXED_STEPS + fresh)
    check_falls("retrieval train", losses[:FIXED_STEPS])
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[retrieval train] in_batch_softmax_loss with logQ: losses "
        f"{losses}; peak device memory {peak:.2f} GB")
    tutorial = Trainer(model, DenseAdagrad(model.parameters(), TT_LR),
                       tutorial_loss)
    t_losses = step_losses(tutorial, [fixed] * TT_SECOND_LOSS_STEPS)
    if not all(math.isfinite(x) for x in t_losses):
        fail(f"retrieval train: tutorial loss {t_losses}")
    log(f"[retrieval train] RemoveAccidentalHits + HardNegativeMining("
        f"{TT_HARD_NEGATIVES}) + SamplingProbabilityCorrection: losses "
        f"{t_losses}")
    del trainer, tutorial
    serve_two_tower(model, rng, perms)
    del model
    torch.cuda.empty_cache()
    serve_brute_force(dev, seed)
    serve_ivf(dev, seed)


def serve_two_tower(model, rng, perms) -> None:
    """Phase 20a: make_retrieval over all TT_ITEMS candidates; 3 batches
    of SERVE_BATCH queries on the exact chunked path and with
    recall_target 0.95, both equal to a direct top-k on the card."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )
    from keras_rs_tpu_torch.ops.topk import top_k

    dev = model.candidate_embedding.embeddings.device
    retrieval = model.make_retrieval(k=SERVE_K)
    approx = BruteForceRetrieval(retrieval.candidate_embeddings, k=SERVE_K,
                                 recall_target=0.95)
    with torch.no_grad():
        for _ in range(SCORE_BATCHES):
            ids = torch.from_numpy(zipf_ids(rng, TT_QUERIES, SERVE_BATCH,
                                            perms[0])).to(dev)
            q = model.query_tower(ids)
            _, i = retrieval(q)
            _, di = top_k(q @ retrieval.candidate_embeddings.T, SERVE_K)
            _, ai = approx(q)
            if not (torch.equal(i, di) and torch.equal(ai, di)):
                fail("retrieval serve: chunked ids differ from the direct "
                     "top-k")
    log(f"[retrieval serve] {TT_ITEMS} candidates embedded; top-{SERVE_K} "
        f"of {SERVE_BATCH} queries, chunked exact path and direct [B, N] "
        "path: ids equal (recall_target=0.95 too)")


def serve_brute_force(dev, seed: int) -> None:
    """Phase 20b: the chunked exact path over BRUTE_N x TT_DIM f32
    candidates, 3 batches; BRUTE_CHECK_ROWS queries also against a direct
    top-k."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )
    from keras_rs_tpu_torch.ops.topk import top_k

    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(dev).manual_seed(seed)
    cands = torch.randn((BRUTE_N, TT_DIM), generator=g, device=dev)
    layer = BruteForceRetrieval(cands, k=SERVE_K)
    for _ in range(SCORE_BATCHES):
        q = torch.randn((SERVE_BATCH, TT_DIM), generator=g, device=dev)
        _, i = layer(q)
    _, di = top_k(q[:BRUTE_CHECK_ROWS] @ cands.T, SERVE_K)
    if not torch.equal(i[:BRUTE_CHECK_ROWS], di):
        fail("brute force: chunked ids differ from the direct top-k")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[retrieval brute] {BRUTE_N} x {TT_DIM} f32 candidates "
        f"({cands.numel() * 4 / 1e9:.2f} GB), "
        f"{-(-BRUTE_N // 65536)} chunks, {SCORE_BATCHES} batches of "
        f"{SERVE_BATCH}; {BRUTE_CHECK_ROWS} rows equal a direct top-k; peak "
        f"device memory {peak:.2f} GB")
    del cands, layer
    torch.cuda.empty_cache()


def mixture(g, n: int, centres):
    """n points of the Gaussian mixture: a uniform centre plus
    IVF_SPREAD-scaled N(0, 1) noise."""
    import torch

    pick = torch.randint(centres.shape[0], (n,), generator=g,
                         device=centres.device)
    return centres[pick] + IVF_SPREAD * torch.randn(
        (n, centres.shape[1]), generator=g, device=centres.device)


def serve_ivf(dev, seed: int) -> None:
    """Phase 20c: KMeansRetrieval over IVF_N mixture points (default
    num_clusters, IVF_PROBES probes), f32 and int8 + reorder: peak memory
    per batch, recall@10 against the exact top-10 (>
    IVF_RECALL_GATE); then full probing at IVF_EXACT_N equals brute
    force."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval.kmeans_retrieval import (
        KMeansRetrieval,
    )
    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )

    g = torch.Generator(dev).manual_seed(seed)
    centres = torch.randn((IVF_CENTRES, TT_DIM), generator=g, device=dev)
    corpus = mixture(g, IVF_N, centres)
    queries = [mixture(g, SERVE_BATCH, centres)
               for _ in range(SCORE_BATCHES)]
    exact = BruteForceRetrieval(corpus, k=SERVE_K)
    want = [exact(q)[1] for q in queries]
    for quantize in (None, "int8"):
        layer = KMeansRetrieval(corpus, k=SERVE_K, num_probes=IVF_PROBES,
                                quantize=quantize, seed=seed, device=dev)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        recall = []
        for q, w in zip(queries, want):
            _, ids = layer(q)
            hits = (ids[:, :, None] == w[:, None, :]).any(dim=2)
            recall.append(float(hits.float().mean()))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        K, cap = layer.cluster_valid.shape
        label = quantize or "f32"
        log(f"[ivf {label}] {IVF_N} x {TT_DIM} mixture of {IVF_CENTRES} "
            f"centres: {K} clusters (capacity {cap}, mean "
            f"{IVF_N / K:.0f}); {IVF_PROBES} probes, batches of "
            f"{SERVE_BATCH}: recall@{SERVE_K} {recall}; serving peak "
            f"{peak:.2f} GB over the index")
        if min(recall) <= IVF_RECALL_GATE:
            fail(f"ivf {label}: recall {recall} <= {IVF_RECALL_GATE}")
        del layer
        torch.cuda.empty_cache()

    small = corpus[:IVF_EXACT_N]
    q = queries[0][:IVF_EXACT_QUERIES]
    clusters = int(np.sqrt(IVF_EXACT_N))
    layer = KMeansRetrieval(small, k=SERVE_K, num_probes=clusters,
                            seed=seed, device=dev)
    s, ids = layer(q)
    ws, wi = BruteForceRetrieval(small, k=SERVE_K)(q)
    same_order = bool(torch.equal(ids, wi))
    if not torch.equal(ids.sort(dim=1).values, wi.sort(dim=1).values):
        fail("ivf: full probing differs from brute force")
    log(f"[ivf exact] {IVF_EXACT_N} candidates, {clusters} of {clusters} "
        f"clusters probed: the ids of {IVF_EXACT_QUERIES} queries equal "
        f"brute force's (in the same order: {same_order}; scores within "
        f"{float((s - ws).abs().max())!r})")
    del layer, corpus
    torch.cuda.empty_cache()


def ranking_inputs(rng, b: int, n: int) -> dict:
    """Graded labels 0-4 with ~10% -1 (invalid), a ~90% mask, per-list
    and per-item weights, scores with ties (one decimal) and tie-free
    scores."""
    labels = rng.integers(0, 5, size=(b, n)).astype(np.float32)
    labels[rng.random((b, n)) < 0.1] = -1.0
    return {
        "labels": labels,
        "mask": rng.random((b, n)) > 0.1,
        "list_weights": rng.random(b).astype(np.float32),
        "item_weights": rng.random((b, n)).astype(np.float32),
        "tied": np.round(rng.standard_normal((b, n)), 1).astype(np.float32),
        "distinct": (rng.permutation(b * n).reshape(b, n) / (b * n)).astype(
            np.float32),
    }


def phase_ranking_modules(dev, seed: int) -> None:
    """Phase 21a: the 5 losses and 6 metrics on [RANK_BATCH, RANK_LIST]
    lists on the card against the same module on the CPU (dict labels
    with masks, -1 labels, sample weights), within RANK_TOL relative."""
    import torch

    from keras_rs_tpu_torch.losses import list_mle_loss, pairwise_losses
    from keras_rs_tpu_torch.metrics import ranking_metrics

    x = ranking_inputs(np.random.default_rng(seed), RANK_BATCH, RANK_LIST)
    loss_cls = [pairwise_losses.PairwiseHingeLoss,
                pairwise_losses.PairwiseLogisticLoss,
                pairwise_losses.PairwiseSoftZeroOneLoss,
                pairwise_losses.PairwiseMeanSquaredError,
                list_mle_loss.ListMLELoss]
    gaps = {}
    for cls in loss_cls:
        out = {}
        for d in ("cpu", dev):
            t = {k: torch.from_numpy(v).to(d) for k, v in x.items()}
            w = t["list_weights"] if cls is list_mle_loss.ListMLELoss \
                else t["item_weights"]
            out[d] = float(cls()({"labels": t["labels"], "mask": t["mask"]},
                                 t["tied"], w))
        gaps[cls.__name__] = relative_gap(out[dev], out["cpu"])
    metric_cls = [ranking_metrics.DCG, ranking_metrics.NDCG,
                  ranking_metrics.MeanAveragePrecision,
                  ranking_metrics.MeanReciprocalRank,
                  ranking_metrics.PrecisionAtK, ranking_metrics.RecallAtK]
    for cls in metric_cls:
        for shuffle in (False, True):
            out = {}
            for d in ("cpu", dev):
                t = {k: torch.from_numpy(v).to(d) for k, v in x.items()}
                m = cls(k=10, shuffle_ties=shuffle, seed=seed, device=d)
                if shuffle:  # tie-free scores, nothing masked: no draw
                    m.update_state(t["labels"].abs(), t["distinct"])
                else:
                    m.update_state({"labels": t["labels"],
                                    "mask": t["mask"]}, t["tied"],
                                   t["list_weights"])
                out[d] = float(m.result())
            gaps[f"{cls.__name__}(shuffle_ties={shuffle})"] = relative_gap(
                out[dev], out["cpu"])
    log(f"[ranking modules] card vs CPU on [{RANK_BATCH}, {RANK_LIST}] "
        f"lists, relative gaps {gaps}")
    if max(gaps.values()) > RANK_TOL:
        fail(f"ranking modules: card and CPU disagree beyond {RANK_TOL}")


def ranking_lists(rng, factors, batch: int) -> dict:
    """examples/listwise_ranking.py's lists at RANK_* widths: ratings from
    fixed latent factors plus noise, clipped to [0, 5]."""
    u_f, i_f = factors
    users = rng.integers(0, RANK_USERS, size=batch)
    items = rng.integers(0, RANK_ITEMS, size=(batch, RANK_LIST))
    labels = np.einsum("ld,lkd->lk", u_f[users], i_f[items]) + 0.25 * \
        rng.normal(size=items.shape)
    return {"user": users, "items": items,
            "labels": np.clip(2.5 + 2 * labels, 0, 5).astype(np.float32)}


def item_scores(model, users, items):
    """Per-item scores of [B, L] lists (examples/listwise_ranking.py)."""
    b, n = items.shape
    q = model.query_tower(users)[:, None, :]
    c = model.candidate_tower(items.reshape(-1)).reshape(b, n, -1)
    return (q * c).sum(dim=-1)


def run_ranking(dev, seed: int) -> None:
    """Phase 21: the ranking modules card vs CPU; the listwise path
    (TwoTower over lists, ListMLE and PairwiseLogistic, RANK_STEPS steps
    each, then NDCG@10, MAP and MRR over held-out batches); BasicRanking
    RANK_STEPS steps of mse_loss."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import movielens_like
    from keras_rs_tpu_torch.losses import list_mle_loss, pairwise_losses
    from keras_rs_tpu_torch.metrics import ranking_metrics
    from keras_rs_tpu_torch.models.ranking_model import BasicRanking, mse_loss
    from keras_rs_tpu_torch.models.two_tower import TwoTower
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        DenseAdam,
    )
    from keras_rs_tpu_torch.training.trainer import Trainer

    phase_ranking_modules(dev, seed)
    rng = np.random.default_rng(seed)
    factors = (rng.normal(size=(RANK_USERS, 4)) / 2.0,
               rng.normal(size=(RANK_ITEMS, 4)) / 2.0)
    fixed = ranking_lists(rng, factors, RANK_BATCH)
    held_out = [ranking_lists(rng, factors, RANK_BATCH)
                for _ in range(RANK_EVAL_BATCHES)]
    for loss in (list_mle_loss.ListMLELoss(),
                 pairwise_losses.PairwiseLogisticLoss()):
        torch.cuda.reset_peak_memory_stats()
        model = TwoTower(RANK_USERS, RANK_ITEMS, TT_DIM, tower_units=TT_UNITS,
                         generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)

        def loss_fn(m, b, loss=loss):
            return loss(b["labels"], item_scores(m, b["user"], b["items"]))

        trainer = Trainer(model, DenseAdagrad(model.parameters(), RANK_LR),
                          loss_fn)
        losses = step_losses(trainer, [fixed] * RANK_STEPS)
        check_falls(f"listwise {loss.name}", losses)
        metrics = {"NDCG@10": ranking_metrics.NDCG(k=10, device=dev),
                   "MAP": ranking_metrics.MeanAveragePrecision(device=dev),
                   "MRR": ranking_metrics.MeanReciprocalRank(device=dev)}
        with torch.no_grad():
            for b in held_out:
                t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                scores = item_scores(model, t["user"], t["items"])
                # MAP and MRR over binary relevance: each list's top-rated
                # item(s), as the example binarizes.
                best = (t["labels"] >= t["labels"].amax(dim=1, keepdim=True)
                        - 1e-6).float()
                metrics["NDCG@10"].update_state(t["labels"], scores)
                metrics["MAP"].update_state(best, scores)
                metrics["MRR"].update_state(best, scores)
        results = {k: float(m.result()) for k, m in metrics.items()}
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0
                   for v in results.values()):
            fail(f"listwise {loss.name}: metrics {results}")
        log(f"[listwise {loss.name}] {RANK_BATCH} lists of {RANK_LIST}: "
            f"losses {losses}; held-out {results}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del model, trainer
        torch.cuda.empty_cache()

    data = movielens_like(num_users=BR_USERS, num_items=BR_ITEMS,
                          num_examples=BR_BATCH, seed=seed)
    model = BasicRanking(BR_USERS, BR_ITEMS,
                         generator=torch.Generator(dev).manual_seed(seed),
                         device=dev)
    trainer = Trainer(model, DenseAdam(model.parameters(), BR_LR), mse_loss)
    losses = step_losses(trainer, [data] * RANK_STEPS)
    check_falls("basic ranking", losses)
    log(f"[basic ranking] {BR_USERS} users, {BR_ITEMS} items, dim 32, MLP "
        f"(256, 64, 1), batch {BR_BATCH}: mse losses {losses}")


# --- Serving: freeze, int8, CUDA graphs, export (phases 22-25) -----------

SERVE_SMALL_BATCH = 512  # the small request batch of phase 23
#: freeze() layouts: f32, then int8 in the "rows", "packed" and "fused"
#: layouts of ops/quant.py.
QUANTIZE = (None, "int8", "int8_packed", "int8_fused")
EXPORT_CANDIDATES = 100_000  # retrieval service of phase 25
#: Frozen f32 logits against the trained model's: the bf16 dense stack's
#: bound (ROADMAP C4); the embedding activations are the same sums.
FROZEN_LOGIT_TOL = 5e-3


def ragged_requests(raw: dict, rng, large_idx, narrow: bool = False) -> dict:
    """`raw` with each large feature cut to a Ragged batch: row b keeps
    its first n_b ids, n_b uniform in [1, m] (in [1, m - 1] where m > 1
    and `narrow`, so that every such feature is narrower than its
    valence and the stacked lookup takes its sorted forward)."""
    from keras_rs_tpu_torch.data.ragged import Ragged

    out = dict(raw)
    for i in large_idx:
        ids = raw[f"cat_{i}"]
        B, m = ids.shape
        hi = m - 1 if narrow and m > 1 else m
        n = rng.integers(1, hi + 1, size=B)
        keep = np.arange(m)[None, :] < n[:, None]
        out[f"cat_{i}"] = Ragged(ids[keep], n.astype(np.int32))
    return out


def frozen_request(model, raw: dict, dev) -> tuple[dict, dict, dict]:
    """(the batch without its large features, their padded ids, their 0/1
    weights) as tensors on `dev`: each Ragged feature padded to its
    valence, a static shape for a captured graph."""
    import torch

    from keras_rs_tpu_torch.data.ragged import Ragged

    batch, ids, weights = {}, {}, {}
    for k, v in raw.items():
        if k == "label":
            continue
        if isinstance(v, Ragged):
            m = model.config.multi_hot_sizes[int(k.split("_")[1])]
            a, w = v.to_padded(max_length=m)
            ids[k] = torch.from_numpy(a).to(dev)
            weights[k] = torch.from_numpy(w).to(dev)
        else:
            batch[k] = torch.from_numpy(np.asarray(v)).to(dev)
    return batch, ids, weights


def frozen_scorer(model, frozen):
    """serve(batch, large ids, large weights) -> logits: the frozen large
    features feed the model's dense stack through "large_acts"."""

    def serve(batch, ids, weights):
        return model({**batch, "large_acts": frozen(ids, weights)})

    return serve


def module_bytes(module) -> int:
    """Bytes of a module's distinct parameters and buffers."""
    seen = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    return sum(t.numel() * t.element_size() for t in seen.values())


def int8_bound(frozen_rows, ids: dict, weights: dict) -> dict:
    """Per feature, the largest |int8 - f32| activation error the
    quantization allows: sum over the row's ids of |weight| * scale / 2
    (scale = the row's absmax / 127), from an "int8" (rows layout)
    freeze; [B] per feature."""
    out = {}
    for name, er in frozen_rows._reducers.items():
        s = er.scale[ids[name].clamp(0, er.input_dim - 1)][..., 0]
        out[name] = 0.5 * (s * weights[name].abs()).sum(-1)
    return out


def check_within_int8_bound(label: str, got: dict, want: dict,
                            bound: dict) -> float:
    """Fails unless every activation of `got` is within its int8 bound
    (plus 1e-6 relative for the f32 sums) of `want`; returns the largest
    error over bound."""
    import torch

    worst = 0.0
    for k, b in bound.items():
        err = (got[k].float() - want[k].float()).abs()
        limit = b[:, None] * (1 + 1e-5) + 1e-6 * want[k].float().abs() + 1e-7
        if bool((err > limit).any()):
            fail(f"{label}: feature {k} int8 error {float(err.max())!r} over "
                 "its bound")
        worst = max(worst, float((err / limit).max()))
    return worst


def phase_serving_small(seed: int) -> None:
    """Phase 22: small DLRMs (f32 + Adagrad, packed state; capacity mode,
    bf16 + row-wise Adagrad) on the card and on the CPU from the same
    state: every freeze layout's int8 q, scale and packed words bit-exact
    card vs CPU, activations within 1e-6 relative; on the card, Ragged
    and sparse requests equal their padded form, and serving_copy equals
    the trained layer's no-grad forward (construction-order and sorted),
    holds no slot and shares no storage with it; then 3 training steps on
    Ragged batches narrower than the valence (sorted forward), card
    against CPU."""
    import torch

    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2

    dev = torch.device("cuda", 0)
    B = SMALL_BATCH
    for label, overrides in (("f32", {}), ("capacity", dict(
            table_dtype="bfloat16", embedding_optimizer="rowwise_adagrad"))):
        cfg = small_config(**overrides)
        models = {d: DLRMDCNv2(cfg, generator=torch.Generator(
            device=d).manual_seed(seed), device=d) for d in ("cpu", "cuda")}
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        raw = criteo_like_batch(B, vocab_sizes=cfg.vocab_sizes,
                                multi_hot_sizes=cfg.multi_hot_sizes,
                                seed=seed + 7)
        rng = np.random.default_rng(seed)
        req = ragged_requests(raw, rng, models["cpu"].large_idx)
        large = {k: v for k, v in req.items() if k in ("cat_0", "cat_1")}
        worst = 0.0
        for q in QUANTIZE:
            fz = {d: m.embedding_layer.freeze(quantize=q)
                  for d, m in models.items()}
            for a, b in zip(fz["cuda"].table_reducers,
                            fz["cpu"].table_reducers):
                for (name, t), (_, c) in zip(
                        [*a.named_parameters(), *a.named_buffers()],
                        [*b.named_parameters(), *b.named_buffers()]):
                    if not torch.equal(t.detach().cpu(), c.detach()):
                        fail(f"serving small {label}: freeze {q} {name} "
                             "differs between card and CPU")
            with torch.no_grad():
                got = fz["cuda"](large)
                want = fz["cpu"](large)
                worst = max(worst, max(
                    float((got[k].cpu() - want[k]).abs().max())
                    / float(want[k].abs().max()) for k in want))
                # The padded and sparse forms of the same request.
                padded = {k: v.to_padded() for k, v in large.items()}
                ids = {k: torch.from_numpy(a).to(dev)
                       for k, (a, _) in padded.items()}
                w = {k: torch.from_numpy(b).to(dev)
                     for k, (_, b) in padded.items()}
                sparse = {k: torch.sparse_coo_tensor(
                    (w[k] > 0).nonzero().T, ids[k][w[k] > 0],
                    tuple(ids[k].shape), check_invariants=True)
                    for k in ids}
                for form, out in (("padded", fz["cuda"](ids, w)),
                                  ("sparse", fz["cuda"](sparse))):
                    if any(not torch.equal(out[k], got[k]) for k in got):
                        fail(f"serving small {label}: freeze {q}: the "
                             f"{form} request differs from the Ragged one")
            del fz
        if worst > 1e-6:
            fail(f"serving small {label}: card vs CPU activations differ by "
                 f"{worst!r} of their largest magnitude")
        emb = models["cuda"].embedding_layer
        copy = emb.serving_copy()
        narrow = ragged_requests(raw, rng, models["cpu"].large_idx,
                                 narrow=True)
        with torch.no_grad():
            for form, r in (("full", req), ("narrow", narrow)):
                pre = emb.preprocess({k: r[k] for k in ("cat_0", "cat_1")})
                a, b = copy(pre), emb(pre)
                gap = max(float((a[k] - b[k]).abs().max()) for k in a)
                if gap > 1e-6 * max(float(b[k].abs().max()) for k in b):
                    fail(f"serving small {label}: serving_copy differs from "
                         f"the trained layer by {gap!r} ({form} request)")
        own = {t.untyped_storage().data_ptr() for t in emb.buffers()}
        if any(t.untyped_storage().data_ptr() in own
               for t in copy.buffers()) or any(
                   "_slot_" in n for n, _ in copy.named_buffers()):
            fail(f"serving small {label}: serving_copy shares storage or "
                 "holds slots")
        log(f"[serving small {label}] 4 freeze layouts: tables and int8 "
            f"words equal card vs CPU, activations within {worst!r}; "
            "Ragged = padded = sparse requests; serving_copy "
            f"{module_bytes(copy)} B vs {module_bytes(emb)} B trained, "
            "equal outputs (construction and sorted forward)")
        del models, copy, emb
    phase_small_reference("f32 narrow ragged", "f32",
                          {"apply_scatter_row_blocks": 3}, narrow=True)
    phase_small_reference("capacity narrow ragged", "bf16 tables",
                          {"scatter_rows": 3, "apply_split_rows": 3},
                          narrow=True,
                          table_dtype="bfloat16",
                          embedding_optimizer="rowwise_adagrad")


def phase_dlrm_serve(model, cfg, seed: int) -> None:
    """Phase 23: the trained packed DLRM (4M cap) frozen in f32 and in the
    three int8 layouts, serving 3 request batches of BATCH and 3 of
    SERVE_SMALL_BATCH (large features Ragged, lengths uniform in [1,
    multi-hot size]) eagerly and through serving.aot_compile (CUDA
    graphs); then serving_copy() through the sorted forward."""
    import torch

    from keras_rs_tpu_torch import serving

    dev = torch.device("cuda", 0)
    emb = model.embedding_layer
    rng = np.random.default_rng(seed + 500)
    before = launch_counts()
    sizes = (cfg.global_batch_size, SERVE_SMALL_BATCH)
    raws = {size: [ragged_requests(dlrm_batch(cfg, seed + 200 + s, size),
                                   rng, model.large_idx)
                   for s in range(SCORE_BATCHES)] for size in sizes}
    reqs = {size: [frozen_request(model, r, dev) for r in rs]
            for size, rs in raws.items()}
    with torch.no_grad():
        trained = [model(model.preprocess(r)) for r in raws[sizes[0]]]
    state_bytes = sum(t.numel() * t.element_size()
                      for n, t in emb.named_buffers()
                      if n.startswith("stack"))
    acts, logits, bound = {}, {}, None
    for q in QUANTIZE:
        torch.cuda.reset_peak_memory_stats()
        frozen = emb.freeze(quantize=q)
        serve = frozen_scorer(model, frozen)
        with torch.no_grad():
            acts[q] = [frozen(ids, w) for _, ids, w in reqs[sizes[0]]]
            logits[q] = {size: [serve(*r) for r in rs]
                         for size, rs in reqs.items()}
            # The eager request path reads no value back to the host.
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                serve(*reqs[sizes[1]][0])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if q == "int8":
            bound = [int8_bound(frozen, ids, w)
                     for _, ids, w in reqs[sizes[0]]]
        for size, rs in reqs.items():
            for out in logits[q][size]:
                if not bool(torch.isfinite(out).all()):
                    fail(f"dlrm serve {q}: non-finite logits")
            compiled = serving.aot_compile(serve, *rs[0])
            for r, want in zip(rs, logits[q][size]):
                if not torch.equal(compiled(*r), want):
                    gap = float((compiled(*r) - want).abs().max())
                    fail(f"dlrm serve {q}: aot_compile differs from eager "
                         f"at batch {size} by {gap!r}")
            del compiled
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[dlrm serve {q or 'f32'}] frozen {module_bytes(frozen)} B; "
            f"batches of {sizes}, eager and CUDA graph equal; peak device "
            f"memory {peak:.2f} GB (training state "
            f"{state_bytes / 1e9:.2f} GB resident)")
        del frozen, serve
        torch.cuda.empty_cache()
    # Frozen f32 against the trained model; int8 layouts against each
    # other and within the int8 bound of f32.
    gap = max(float((a - b).abs().max())
              for a, b in zip(logits[None][sizes[0]], trained))
    if gap > FROZEN_LOGIT_TOL:
        fail(f"dlrm serve: frozen f32 logits differ from the model's by "
             f"{gap!r}")
    for q in ("int8_packed", "int8_fused"):
        for size in sizes:
            if any(not torch.equal(a, b) for a, b in zip(
                    logits[q][size], logits["int8"][size])):
                fail(f"dlrm serve: {q} logits differ from int8 rows")
        if any(not torch.equal(a[k], b[k]) for a, b in zip(
                acts[q], acts["int8"]) for k in a):
            fail(f"dlrm serve: {q} activations differ from int8 rows")
    ratio = max(check_within_int8_bound("dlrm serve", a8, a32, b)
                for a8, a32, b in zip(acts["int8"], acts[None], bound))
    logit_gap = max(float((a - b).abs().max()) for size in sizes
                    for a, b in zip(logits["int8"][size], logits[None][size]))
    log(f"[dlrm serve] frozen f32 vs trained model logits: max |diff| "
        f"{gap!r} (bound {FROZEN_LOGIT_TOL}); int8 rows = packed = fused "
        f"bit for bit; int8 activations within {ratio:.4f} of their bound "
        f"(absmax/254 per id), int8 logits vs f32 max |diff| {logit_gap!r}")
    del acts, logits, bound

    # serving_copy: the slot-free stacked twin, host COO + lookup.
    torch.cuda.reset_peak_memory_stats()
    copy = emb.serving_copy()
    copy_bytes = sum(t.numel() * t.element_size()
                     for n, t in copy.named_buffers() if n.startswith("stack"))
    own = {t.untyped_storage().data_ptr() for t in emb.buffers()}
    if any(t.untyped_storage().data_ptr() in own for t in copy.buffers()):
        fail("dlrm serve: serving_copy shares storage with the model")
    large = [f"cat_{i}" for i in model.large_idx]
    with torch.no_grad():
        # Full-width ids take the construction-order forward, Ragged rows
        # narrower than every valence the sorted one.
        for form, narrow in (("construction", False), ("sorted", True)):
            rs = [dlrm_batch(cfg, seed + 250 + s)
                  for s in range(SCORE_BATCHES)]
            if narrow:
                rs = [ragged_requests(r, rng, model.large_idx, narrow=True)
                      for r in rs]
            for r in rs:
                pre = copy.preprocess({k: r[k] for k in large})
                if ("fwd_slots" in pre["sharded"][copy.stacks[0].name]) != (
                        not narrow):
                    fail(f"dlrm serve: serving_copy took the wrong forward "
                         f"({form})")
                a, b = copy(pre), emb(pre)
                rel = max(float((a[k] - b[k]).abs().max())
                          / max(float(b[k].abs().max()), 1e-30) for k in a)
                if rel > 1e-5 or (not narrow and rel != 0.0):
                    fail(f"dlrm serve: serving_copy differs from the model "
                         f"by {rel!r} relative ({form})")
    log(f"[dlrm serve copy] serving_copy state {copy_bytes} B "
        f"({copy_bytes / 1e9:.2f} GB) vs packed training state "
        f"{state_bytes} B ({state_bytes / 1e9:.2f} GB); batches of "
        f"{cfg.global_batch_size} through the construction-order and the "
        f"sorted forward equal to the trained layer; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del copy
    torch.cuda.empty_cache()
    if launch_counts() != before:
        fail("dlrm serve: a kernel launched while serving")


def phase_capacity_serve(model, cfg, seed: int) -> None:
    """Phase 24: the trained capacity-mode DLRM on the uncut vocabulary:
    its scoring logits on 3 Ragged request batches, freeze(quantize=
    "int8") chunk by chunk beside the training state (peak gated below
    the card's memory), the training state freed, then the 3 batches
    served from the int8 tables: finite, activations within the int8
    bound of the bf16 model's."""
    import gc

    import torch

    dev = torch.device("cuda", 0)
    emb = model.embedding_layer
    rng = np.random.default_rng(seed + 600)
    before = launch_counts()
    large = [f"cat_{i}" for i in model.large_idx]
    raws = [ragged_requests(dlrm_batch(cfg, seed + 400 + s), rng,
                            model.large_idx) for s in range(SCORE_BATCHES)]
    reqs = [frozen_request(model, r, dev) for r in raws]
    want_acts, want_logits = [], []
    with torch.no_grad():
        for r in raws:
            pre = model.preprocess(r)
            want_acts.append(emb(pre["large_pre"]))
            want_logits.append(model(pre))
    del pre
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    frozen = emb.freeze(quantize="int8")
    peak = torch.cuda.max_memory_allocated()
    if peak >= total:
        fail(f"capacity serve: freeze peak {peak} B over the card's {total}")
    log(f"[capacity serve] freeze(quantize='int8') of "
        f"{sum(er.input_dim for er in frozen.table_reducers)} rows: "
        f"{module_bytes(frozen)} B "
        f"({module_bytes(frozen) / 1e9:.2f} GB) of int8 tables and scales; peak device memory {peak / 1e9:.2f} "
        f"GB of {total / 1e9:.2f} GB, the bf16 training state resident")
    bound = [int8_bound(frozen, ids, w) for _, ids, w in reqs]
    model.embedding_layer = None
    del emb
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve = frozen_scorer(model, frozen)
    with torch.no_grad():
        acts = [frozen(ids, w) for _, ids, w in reqs]
        logits = [serve(*r) for r in reqs]
    for out in logits:
        if not bool(torch.isfinite(out).all()):
            fail("capacity serve: non-finite logits")
    ratio = max(check_within_int8_bound("capacity serve", a, b, bd)
                for a, b, bd in zip(acts, want_acts, bound))
    gap = max(float((a - b).abs().max())
              for a, b in zip(logits, want_logits))
    log(f"[capacity serve] training state freed; {SCORE_BATCHES} batches of "
        f"{cfg.global_batch_size}: serving peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; int8 activations "
        f"within {ratio:.4f} of their bound (absmax/254 per id) of the bf16 "
        f"model's; logits vs the bf16 model's max |diff| {gap!r}")
    if launch_counts() != before:
        fail("capacity serve: a kernel launched while serving")
    del frozen, serve, acts, want_acts
    torch.cuda.empty_cache()


def phase_export(seed: int) -> None:
    """Phase 25: export_fn / import_fn on the card of an int8-frozen small
    DLRM and of a retrieval service (an MLP query tower and
    BruteForceRetrieval over EXPORT_CANDIDATES x 128): the imported
    artifact's output equals the eager one; artifact bytes."""
    import torch

    from keras_rs_tpu_torch import serving
    from keras_rs_tpu_torch.data.synthetic import criteo_like_batch
    from keras_rs_tpu_torch.layers.dense import MLP
    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = small_config()
    model = DLRMDCNv2(cfg, generator=g, device=dev)
    frozen = model.embedding_layer.freeze(quantize="int8")
    model.embedding_layer = None  # served from `frozen`: not exported
    req = frozen_request(model, ragged_requests(
        criteo_like_batch(SMALL_BATCH, vocab_sizes=cfg.vocab_sizes,
                          multi_hot_sizes=cfg.multi_hot_sizes, seed=seed),
        np.random.default_rng(seed), model.large_idx), dev)
    serve = frozen_scorer(model, frozen)
    blob = serving.export_fn(serve, *req)
    with torch.no_grad():
        want = serve(*req)
    if not torch.equal(serving.import_fn(blob)(*req), want):
        fail("export: the imported DLRM differs from the eager one")
    tower = MLP(64, [256, 128], generator=g, device=dev)
    cands = torch.randn((EXPORT_CANDIDATES, 128), generator=g, device=dev)
    service = serving.make_retrieval_service(
        tower, BruteForceRetrieval(cands, k=SERVE_K))
    q = torch.randn((SERVE_BATCH, 64), generator=g, device=dev)
    rblob = serving.export_fn(service, q)
    imported = serving.import_fn(rblob)
    with torch.no_grad():
        ws, wi = service(q)
    gs, gi = imported(q)
    if not (torch.equal(gi, wi) and torch.equal(gs, ws)):
        fail("export: the imported retrieval service differs")
    log(f"[export] int8 small DLRM: {len(blob)} B artifact, equal on the "
        f"card; retrieval service (MLP 64-256-128, top-{SERVE_K} over "
        f"{EXPORT_CANDIDATES} x 128, batch of {SERVE_BATCH}): {len(rblob)} "
        "B, equal")


# --- Phases 26-29: GRU4Rec on the full Trainer, layers, checkpoints ----------

# GRU4Rec at the JAX module's default width (models/gru4rec.py:26) over
# MovieLens-1M's 3,706 items (the SASRec slice's), histories of 10 items
# (the reference example's context), Markov sessions as
# examples/sequential_retrieval.py draws them; batch 4,096, the in-batch
# softmax width of the two-tower slice; Adam 0.01.
GRU_ITEMS = 3706
GRU_DIM = 128
GRU_T = 10
GRU_BATCH = 4096
GRU_LR = 0.01
GRU_EPOCHS = 4
GRU_STEPS_PER_EPOCH = 8
GRU_RESUME_STEPS = 3
GRU_SERVE_BATCH = 1024
GRU_HELD_BATCHES = 3  # held-out batches of GRU_SERVE_BATCH histories
GRU_PAD_SHARE = 0.25  # share of histories cut short and left-padded
#: The trained model's held-out recall@10 must exceed the popularity
#: baseline's by this factor: a data split or query tower that leaves
#: the model at popularity level fails phase 27.
GRU_RECALL_OVER_POPULARITY = 5.0
GRU_RESUME_TOL = 1e-6  # relative: the card's embedding backward sums
#                        duplicated ids in an order of its own
# Phase 28: DLRM-DCNv2's cross width (bottom MLP 128 + 26 x 128) and the
# original DLRM interaction over 27 features of 128 at the MLPerf batch.
CROSS_DIM = 128 + 26 * 128
CROSS_PROJECTION = 512
DOT_FEATURES = 27
DOT_DIM = 128
LAYER_CPU_ROWS = 1024  # rows of the card-vs-CPU comparison
LAYER_TOL = 1e-5  # relative to each array's largest magnitude
SCHEDULE_STEPS = 3
DCN_RUNS = 3
SMOKE_DIR = ROOT / "build" / "chip_smoke"
#: Phase 29's ml_perf runs: to step 6 with checkpoints, then resumed to 8.
RESUME_AT = 6
RESUME_TO = 8


@contextlib.contextmanager
def b1_held_to_plain():
    """While open, every B1 call of the embedding backward also runs the
    plain version
    (apply_scatter_row_blocks_reference, uncounted, with the same
    optimizer, schedule included) on a copy of the blocks it updates,
    and compares the live blocks after the kernel with it at phase 2's
    bound. Yields a list with one dict per held call (0-dim device
    tensors step, lr, err, bad, n_valid, and its rows U as an int), read
    once the steps are done: the check makes no host read inside the
    step."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import lookup
    from keras_rs_tpu_torch.ops import row_ops

    launch = lookup.apply_scatter_row_blocks
    calls: list[dict] = []

    def held(packed, idx, grads, scalars, optimizer, n_valid):
        n = idx.shape[0]
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)  # the check's own work
        rows = packed[idx.long()]  # [N, k, dim] before the update
        want = row_ops.apply_scatter_row_blocks_reference(
            rows, torch.arange(n, dtype=torch.int32, device=idx.device),
            grads, scalars, optimizer, n_valid)
        torch.cuda.set_sync_debug_mode(mode)
        out = launch(packed, idx, grads, scalars, optimizer, n_valid)
        torch.cuda.set_sync_debug_mode(0)
        live = (torch.arange(n, device=idx.device)
                < n_valid.reshape(()))[:, None, None]
        diff = (packed[idx.long()] - want).abs()
        calls.append({
            "step": scalars[0].clone(),
            "lr": optimizer.lr(scalars[0]),
            "err": torch.where(live, diff, 0.0).amax(),
            # Phase 2's bound: 4 f32 ulp relative, 1e-12 absolute.
            "bad": (live & (diff > 1e-12 + 4 * 2.0**-23 * want.abs())).any(),
            "n_valid": n_valid.reshape(()).clone(),
            "rows": n,
        })
        del rows, want, diff
        torch.cuda.set_sync_debug_mode(mode)
        return out

    lookup.apply_scatter_row_blocks = held
    try:
        yield calls
    finally:
        lookup.apply_scatter_row_blocks = launch


def lr_schedule(step):
    """The embedding rate of phase 28: the slice's 0.0034, halved every
    two steps, computed from the stack's step counter on the device."""
    return 0.0034 * 0.5 ** (step / 2.0)


def gru_sessions(seed: int, n: int, num_items: int | None = None) -> dict:
    """n Markov sessions of GRU_T + 1 items (branching 12, noise 0.2) over
    `num_items` (default GRU_ITEMS): the first GRU_T are the history, the
    last the target; GRU_PAD_SHARE of
    the histories keep only their last 1 to GRU_T - 1 items behind id 0."""
    from keras_rs_tpu_torch.data import synthetic

    seq = synthetic.markov_sessions(num_items=num_items or GRU_ITEMS,
                                    num_sessions=n,
                                    length=GRU_T + 1, branching=12,
                                    noise=0.2, seed=seed)
    hist = seq[:, :GRU_T].copy()
    rng = np.random.default_rng(seed + 1)
    short = rng.random(n) < GRU_PAD_SHARE
    keep = rng.integers(1, GRU_T, size=n)
    hist[short[:, None] & (np.arange(GRU_T)[None, :]
                           < (GRU_T - keep)[:, None])] = 0
    return {"item_history": hist, "target_item": seq[:, GRU_T].copy(),
            "sessions": seq}


def split_sessions(data: dict, n: int) -> tuple[dict, dict]:
    """(the first n sessions, the rest)."""
    return ({k: v[:n] for k, v in data.items()},
            {k: v[n:] for k, v in data.items()})


def gru_batches(data: dict, batch: int) -> list[dict]:
    n = len(data["target_item"])
    return [{"item_history": data["item_history"][i:i + batch],
             "target_item": data["target_item"][i:i + batch]}
            for i in range(0, n - batch + 1, batch)]


def close_to(label: str, got, want, tol: float) -> float:
    """max |got - want| / max |want|, failing the run above `tol`."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    if not err <= tol:
        fail(f"{label}: card and CPU differ by {err!r} of the largest "
             f"value (bound {tol})")
    return err


def phase_gru4rec_small(dev, seed: int) -> None:
    """Phase 26: a small GRU4Rec (200 items, dim 32), 3 Adam steps on the
    card and on the CPU from one state (losses and parameters within
    1e-5); a GRU over inputs whose mask has holes, card against CPU
    within 1e-6."""
    import torch

    from keras_rs_tpu_torch.layers.recurrent import GRU
    from keras_rs_tpu_torch.models.gru4rec import GRU4Rec, gru4rec_loss
    from keras_rs_tpu_torch.training.train_state import DenseAdam
    from keras_rs_tpu_torch.training.trainer import Trainer

    models = {d: GRU4Rec(200, embedding_dim=32, device=d,
                         generator=torch.Generator(d).manual_seed(seed))
              for d in ("cpu", dev)}
    models[dev].load_state_dict(models["cpu"].state_dict())
    batches = gru_batches(gru_sessions(seed, 3 * 64, num_items=200), 64)
    losses = {}
    for d, m in models.items():
        trainer = Trainer(m, DenseAdam(m.parameters(), GRU_LR), gru4rec_loss)
        losses[d] = [float(trainer.step(b)) for b in batches]
    cpu_params = dict(models["cpu"].named_parameters())
    worst = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
                for n, p in models[dev].named_parameters())
    log(f"[gru4rec small] losses card {losses[dev]} cpu {losses['cpu']}; "
        f"parameters within {worst!r} after 3 steps")
    if relative_gap(losses[dev], losses["cpu"]) > 1e-5 or worst > 1e-5:
        fail("gru4rec small: card and CPU disagree")
    grus = {d: GRU(16, 24, device=d,
                   generator=torch.Generator(d).manual_seed(seed))
            for d in ("cpu", dev)}
    grus[dev].load_state_dict(grus["cpu"].state_dict())
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(64, 12, 16, generator=g)
    mask = (torch.rand(64, 12, generator=g) > 0.4).float()
    with torch.no_grad():
        h_cpu = grus["cpu"](x, mask)
        h_dev = grus[dev](x.to(dev), mask.to(dev)).cpu()
    err = float((h_cpu - h_dev).abs().max())
    log(f"[gru4rec small] GRU with holes in {int((mask == 0).sum())} of "
        f"{mask.numel()} steps: card vs CPU max |diff| {err!r}")
    if not err <= 1e-6:
        fail("gru4rec small: the holed-mask GRU differs card vs CPU")


def phase_gru4rec(dev, seed: int) -> None:
    """Phase 27: GRU4Rec(3706, 128) trained through Trainer.fit (prefetch
    2, validation 1 - recall@10 on held-out sessions, checkpoints,
    metrics log), then resumed from `last` into a fresh model against
    the run that goes on in memory, evaluated (Trainer.evaluate, recall@10
    and NDCG@10 over every candidate) and served (make_retrieval(k=10)
    over the 3,707-row table, batches of 1,024)."""
    import json
    import os
    import shutil

    import torch

    from keras_rs_tpu_torch.metrics.ranking_metrics import NDCG, RecallAtK
    from keras_rs_tpu_torch.models.gru4rec import GRU4Rec, gru4rec_loss
    from keras_rs_tpu_torch.training import checkpoint
    from keras_rs_tpu_torch.training.train_state import DenseAdam
    from keras_rs_tpu_torch.training.trainer import Trainer, batch_to_device

    work = SMOKE_DIR / "gru4rec"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n_train = GRU_BATCH * GRU_STEPS_PER_EPOCH
    n_held = GRU_SERVE_BATCH * GRU_HELD_BATCHES
    n_resume = GRU_BATCH * GRU_RESUME_STEPS
    # One draw: the seed also fixes the Markov graph, which the held-out
    # and resume sessions must share with the training ones.
    every = gru_sessions(seed, n_train + n_resume + n_held)
    train, rest = split_sessions(every, n_train)
    resume, held = split_sessions(rest, n_resume)
    resume = gru_batches(resume, GRU_BATCH)
    log(f"[gru4rec data] {n_train + n_resume + n_held} sessions; "
        f"{int((train['item_history'] == 0).any(1).sum())} of {n_train} "
        "training histories left-padded")

    model = GRU4Rec(GRU_ITEMS, GRU_DIM, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
    trainer = Trainer(model, DenseAdam(model.parameters(), GRU_LR),
                      gru4rec_loss)
    held_hist = torch.from_numpy(held["item_history"]).to(dev)
    held_target = torch.from_numpy(held["target_item"]).to(dev)

    def recall_at_10(m) -> torch.Tensor:
        with torch.no_grad():
            top = m.make_retrieval(k=10)(m.query_tower(held_hist))
        return (top == held_target[:, None]).any(1).float().mean()

    def validation(m) -> float:
        return float(1.0 - recall_at_10(m))

    def epochs():
        order = np.random.default_rng(seed).permutation(n_train)
        for i in range(0, n_train, GRU_BATCH):
            j = order[i:i + GRU_BATCH]
            yield {"item_history": train["item_history"][j],
                   "target_item": train["target_item"][j]}

    hist = trainer.fit(epochs, epochs=GRU_EPOCHS, log_every=0, prefetch=2,
                       validation_fn=validation,
                       checkpoint_dir=str(work / "ck"),
                       metrics_log=str(work / "metrics.jsonl"))
    records = [json.loads(x) for x in
               (work / "metrics.jsonl").read_text().splitlines()]
    log(f"[gru4rec train] fit: {GRU_EPOCHS} epochs of {GRU_STEPS_PER_EPOCH} "
        f"steps; epoch losses {hist['loss']}; 1 - "
        f"recall@10 {hist['val']}; metrics log {records}")
    check_falls("gru4rec train", hist["loss"])
    if len(records) != GRU_EPOCHS or sorted(os.listdir(work / "ck")) != [
            "best", "last"]:
        fail("gru4rec train: the metrics log or the checkpoints are missing")

    # Resume: the in-memory run goes on; a fresh model restored from
    # `last` takes the same batches.
    losses = step_losses(trainer, resume)
    fresh = GRU4Rec(GRU_ITEMS, GRU_DIM, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed + 1))
    resumed = Trainer(fresh, DenseAdam(fresh.parameters(), GRU_LR),
                      gru4rec_loss)
    checkpoint.restore_checkpoint(str(work / "ck" / "last"), resumed.state)
    r_losses = step_losses(resumed, resume)
    gap = relative_gap(r_losses, losses)
    ck_bytes = os.path.getsize(work / "ck" / "last")
    log(f"[gru4rec resume] in memory {losses}; restored from last "
        f"{r_losses}; relative gap {gap!r} (bound {GRU_RESUME_TOL}); "
        f"checkpoint {ck_bytes} bytes")
    if not gap <= GRU_RESUME_TOL or resumed.optimizer.count != (
            trainer.optimizer.count):
        fail("gru4rec resume: the restored run does not continue the "
             "in-memory one")
    del resumed, fresh

    batch = batch_to_device(resume[0], dev)
    sites = sync_sites(lambda: trainer.step(batch))
    log(f"[gru4rec train] one step: {len(sites)} host syncs (at {sites})")

    # Recall@10 on held-out sessions against popularity.
    dst = train["sessions"][:, 1:].reshape(-1)
    pop = np.argsort(np.bincount(dst, minlength=GRU_ITEMS + 1))[-10:]
    pop_recall = float(np.isin(held["target_item"], pop).mean())
    recall = float(recall_at_10(model))
    log(f"[gru4rec quality] held-out recall@10 {recall!r} against the "
        f"popularity baseline {pop_recall!r}")
    if not recall > GRU_RECALL_OVER_POPULARITY * pop_recall:
        fail(f"gru4rec quality: held-out recall@10 {recall} is not "
             f"{GRU_RECALL_OVER_POPULARITY}x the popularity baseline "
             f"{pop_recall}")

    def eval_fn(m, b):
        q = m.query_tower(b["item_history"])
        scores = q @ m.candidate_embedding.embeddings.T
        labels = torch.nn.functional.one_hot(b["target_item"].long(),
                                             GRU_ITEMS + 1).float()
        return labels, scores

    held_batches = gru_batches(held, GRU_SERVE_BATCH)
    res = trainer.evaluate(held_batches, {
        "recall@10": RecallAtK(10, shuffle_ties=False, device=dev),
        "ndcg@10": NDCG(10, shuffle_ties=False, device=dev)}, eval_fn)
    log(f"[gru4rec evaluate] {len(held_batches)} batches of "
        f"{GRU_SERVE_BATCH}: {res}")
    if not (0.0 <= res["recall@10"] <= 1.0 and 0.0 <= res["ndcg@10"] <= 1.0
            and math.isfinite(res["loss"])):
        fail(f"gru4rec evaluate: metrics {res}")
    if abs(res["recall@10"] - recall) > 1e-5:
        fail(f"gru4rec evaluate: recall@10 {res['recall@10']} against "
             f"{recall} from make_retrieval")

    retrieval = model.make_retrieval(k=10)
    with torch.no_grad():
        for b in held_batches:
            h = torch.from_numpy(b["item_history"]).to(dev)
            top = retrieval(model.query_tower(h))
            if tuple(top.shape) != (GRU_SERVE_BATCH, 10) or not bool(
                    ((top >= 0) & (top <= GRU_ITEMS)).all()):
                fail("gru4rec serve: top-10 ids out of range")
    log(f"[gru4rec serve] make_retrieval(k=10) over {GRU_ITEMS + 1} rows: "
        f"{len(held_batches)} batches of {GRU_SERVE_BATCH}, ids in range")
    del trainer, model
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_layers(dev, seed: int) -> object:
    """Phase 28: the full-rank and low-rank FeatureCross at the DLRM-DCNv2
    cross width (diag_scale, relu pre-activation, L2 regularizers) and
    DotInteraction over 27 x 128 at batch 16,384 in its four flag
    combinations, forward and backward card against CPU; a learning-rate
    schedule on the packed DLRM slice, 3 steps with B1 once per step and
    stack and no host sync (sync-debug "error"); the port's dcn and
    sequential_retrieval examples on the card. Returns the schedule's
    DLRM for phase 29."""
    import torch

    from keras_rs_tpu_torch.core import regularizers as reg_lib
    from keras_rs_tpu_torch.examples import dcn, sequential_retrieval
    from keras_rs_tpu_torch.layers.feature_interaction.dot_interaction import (
        DotInteraction,
    )
    from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
        FeatureCross,
    )
    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    g = torch.Generator().manual_seed(seed)
    reset_launch_counts()
    for label, kw in (("full rank", {}),
                      ("low rank", {"projection_dim": CROSS_PROJECTION})):
        layers = {d: FeatureCross(
            CROSS_DIM, diag_scale=0.5, pre_activation=torch.relu,
            kernel_regularizer=reg_lib.L2(1e-4),
            bias_regularizer=reg_lib.L2(1e-4), device=d,
            generator=torch.Generator(d).manual_seed(seed), **kw)
            for d in ("cpu", dev)}
        layers[dev].load_state_dict(layers["cpu"].state_dict())
        x0 = torch.randn(LAYER_CPU_ROWS, CROSS_DIM, generator=g)
        x = torch.randn(LAYER_CPU_ROWS, CROSS_DIM, generator=g)
        outs, grads = {}, {}
        for d, layer in layers.items():
            a = x0.to(d, copy=True).requires_grad_()
            out = layer(a, x.to(d))
            loss = (out * out).mean() + reg_lib.regularization_loss(layer)
            loss.backward()
            outs[d] = out
            grads[d] = [a.grad] + [p.grad for p in layer.parameters()]
        errs = [close_to(f"FeatureCross {label}", outs[dev], outs["cpu"],
                         LAYER_TOL)]
        errs += [close_to(f"FeatureCross {label} gradient", gd, gc,
                          LAYER_TOL)
                 for gd, gc in zip(grads[dev], grads["cpu"])]
        log(f"[layers] FeatureCross {label} {CROSS_DIM} (diag 0.5, relu, L2 "
            f"on {sorted(layers[dev]._regularizers)}): card vs CPU at "
            f"{LAYER_CPU_ROWS} rows within {max(errs)!r} of the largest "
            "value")
        del layers, outs, grads
    for self_interaction in (False, True):
        for skip_gather in (False, True):
            layer = DotInteraction(self_interaction, skip_gather)
            feats = [torch.randn(BATCH, DOT_DIM, generator=g)
                     for _ in range(DOT_FEATURES)]
            res = {}
            for d in ("cpu", dev):
                f = [t.to(d, copy=True).requires_grad_() for t in feats]
                out = layer(f)
                (out * out).sum().backward()
                res[d] = [out] + [t.grad for t in f]
            errs = [close_to("DotInteraction", a, b, LAYER_TOL)
                    for a, b in zip(res[dev], res["cpu"])]
            log(f"[layers] DotInteraction self_interaction="
                f"{self_interaction} skip_gather={skip_gather}: "
                f"[{BATCH}, {layer.output_dim(DOT_FEATURES)}], card vs CPU "
                f"within {max(errs)!r}")
            del res
    if any(launch_counts().values()):
        fail(f"layers launched kernels: {launch_counts()}")

    cfg = slice_config(learning_rate=lr_schedule)
    model = build_dlrm("schedule", cfg, seed)
    n_stacks = len(model.embedding_layer.stacks)
    step = make_train_step(model, bce_loss,
                           DenseAdagrad(model.parameters(), 0.0034))
    pres = [model.preprocess(dlrm_batch(cfg, seed + s))
            for s in range(SCHEDULE_STEPS)]
    torch.cuda.synchronize()
    reset_launch_counts()
    with b1_held_to_plain() as calls:
        torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [step(pre) for pre in pres]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    losses = [float(x) for x in losses]
    counts = launch_counts()
    want = {k: SCHEDULE_STEPS * n_stacks if k == "apply_scatter_row_blocks"
            else 0 for k in counts}
    steps = [float(model.embedding_layer.stack_state(i)["step"])
             for i in range(n_stacks)]
    seen = [float(c["step"]) for c in calls]
    rates = [float(c["lr"]) for c in calls]
    errs = [float(c["err"]) for c in calls]
    log(f"[layers] schedule 0.0034 * 0.5^(step / 2) on the packed DLRM: "
        f"losses {losses}; launches {counts}; step counters {steps}; no "
        f"host sync (sync-debug 'error'); B1 at steps {seen}, rates "
        f"{rates}, max |kernel - plain| over the live blocks {errs}")
    if counts != want or not all(map(math.isfinite, losses)):
        fail(f"schedule: launches {counts}, expected {want}; losses "
             f"{losses}")
    expect = [float(s) for s in range(SCHEDULE_STEPS) for _ in
              range(n_stacks)]
    if seen != expect or any(bool(c["bad"]) for c in calls):
        fail(f"schedule: B1 at steps {seen} (expected {expect}) against "
             f"its plain version: max |diff| {errs}")
    for s_, r in zip(seen, rates):
        # The rate in f32: three roundings from the f64 value at most.
        if abs(r - lr_schedule(s_)) > 4 * 2.0**-23 * lr_schedule(s_):
            fail(f"schedule: rate {r} at step {s_}, expected "
                 f"{lr_schedule(s_)}")

    # The examples' per-epoch log lines stay out of the output.
    trainer_log = logging.getLogger("keras_rs_tpu_torch")
    level = trainer_log.level
    trainer_log.setLevel(logging.WARNING)
    res = dcn.main(DCN_RUNS, dev)
    log(f"[layers] examples/dcn.py on the card ({DCN_RUNS} runs per "
        f"architecture): {res}")
    if not all(math.isfinite(res[k][0]) for k in
               ("cross_full", "cross_lowrank", "deep_only")):
        fail(f"dcn example: {res}")
    res = sequential_retrieval.main(dev)
    trainer_log.setLevel(level)
    log(f"[layers] examples/sequential_retrieval.py on the card: {res}")
    if not res["recall"] > res["popularity"]:
        fail(f"sequential_retrieval example: {res}")
    return model, step


def phase_checkpoint(dev, model, step, seed: int) -> None:
    """Phase 29: the ml_perf entry point run to step 6 and then to step 8
    with one checkpoint_dir (the second logs "resumed from checkpoint
    step 6" and trains 2 more steps, held to one process that trains the
    same 8 batches), then with --profile (a non-empty trace of steps
    10-20); then the
    packed 4M-cap state of phase 28's model through save_checkpoint /
    restore_checkpoint, where the disk holds it: bytes, the restore's
    added device memory, and the state back bit for bit after
    one more step changed it."""
    import os
    import shutil

    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.training import checkpoint
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    work = SMOKE_DIR / "checkpoint"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    messages: list[str] = []

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Collect()
    logging.getLogger("ml_perf").addHandler(handler)
    smoke = configs.smoke_test()
    n_stacks = len(mlperf.build_model(smoke, dev).embedding_layer.stacks)
    reset_launch_counts()
    logs, runs = [], []
    try:
        for num_steps in (RESUME_AT, RESUME_TO):
            del messages[:]
            runs.append(mlperf.main(
                "smoke_test", device=dev, num_steps=num_steps,
                checkpoint_dir=str(work / "ck"), checkpoint_every=2,
                num_loader_threads=1))
            logs.append(list(messages))
        prof = mlperf.main("smoke_test", device=dev, num_steps=24,
                           do_profile=True, profile_dir=str(work / "prof"))
    finally:
        logging.getLogger("ml_perf").removeHandler(handler)
    if any("resumed" in m for m in logs[0]) or not any(
            f"resumed from checkpoint step {RESUME_AT}" in m
            for m in logs[1]):
        fail(f"ml_perf checkpoint: the rerun did not resume from step "
             f"{RESUME_AT}")
    # The rerun restored step 6 and, drawing the dummy batches from the
    # start again as the JAX entry point does, trained on batches 0 and
    # 1. Its reference is one process that trains batches 0-5 and then
    # 0-1 again (the CPU test test_resumed_run_continues_the_losses).
    batches = list(CriteoDataset(
        None, global_batch_size=smoke.global_batch_size,
        vocab_sizes=smoke.vocab_sizes,
        multi_hot_sizes=smoke.multi_hot_sizes).dummy_batches(RESUME_AT))
    ref = mlperf.build_model(smoke, dev)
    ref_step = make_train_step(ref, mlperf.make_loss_fn(False),
                               DenseAdagrad(ref.parameters(),
                                            smoke.learning_rate))
    ref_losses = [float(ref_step(ref.preprocess(b)))
                  for b in batches + batches[:RESUME_TO - RESUME_AT]]
    back = mlperf.build_model(smoke, dev)
    checkpoint.CheckpointManager(str(work / "ck")).restore(RESUME_TO, {
        "model": back,
        "optimizer": DenseAdagrad(back.parameters(), smoke.learning_rate)})
    counters = [float(back.embedding_layer.stack_state(i)["step"])
                for i in range(n_stacks)]
    ref_state = ref.state_dict()
    gaps = {name: float((t.float() - ref_state[name].float()).abs().max())
            for name, t in back.state_dict().items() if t.numel()}
    worst = max(gaps, key=gaps.get)
    del ref, ref_step, back, ref_state
    traces = os.listdir(work / "prof")
    sizes = [os.path.getsize(work / "prof" / t) for t in traces]
    counts = launch_counts()
    row = sum(counts[k] for k in ROW_KERNELS)
    # main's runs (8 steps to the resumed end, then 24) and the
    # reference's 8, but for the replays of their graphs.
    want_row = wrapper_steps(RESUME_TO + 24 + RESUME_TO) * n_stacks
    log(f"[checkpoint] ml_perf smoke_test: {RESUME_AT} steps with "
        f"checkpoints, then a rerun to {RESUME_TO} that logged 'resumed "
        f"from checkpoint step {RESUME_AT}' and left "
        f"{sorted(os.listdir(work / 'ck'))}; its loss "
        f"{runs[1]['loss']!r} against {ref_losses[-1]!r} of one process "
        f"over the same batches (bound {MODE_LOSS_BOUND} absolute); its "
        f"step-{RESUME_TO} state's step counters {counters}, largest gap "
        f"to that process's state {gaps[worst]!r} ({worst}); --profile "
        f"over 24 steps wrote {traces} of {sizes} bytes (loss "
        f"{prof['loss']!r}); launches {counts}, {replays()} graph "
        f"replays")
    if (not math.isfinite(runs[1]["loss"])
            or abs(runs[1]["loss"] - ref_losses[-1]) > MODE_LOSS_BOUND
            or counters != [float(RESUME_TO)] * n_stacks):
        fail("ml_perf checkpoint: the resumed run does not continue the "
             "training of one process")
    if len(traces) != 1 or not sizes[0] > 0:
        fail("ml_perf profile: no trace")
    if row != want_row or any(counts[k] for k in FLASH_KERNELS):
        fail(f"ml_perf checkpoint phase: launches {counts}, expected one "
             f"row kernel per step and stack ({want_row})")

    emb = model.embedding_layer
    state_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
    free = shutil.disk_usage(work).free
    if free < 1.2 * state_bytes:
        log(f"[checkpoint] packed 4M-cap state of {state_bytes / 1e9:.2f} "
            f"GB left out: the disk holds {free / 1e9:.2f} GB free")
        shutil.rmtree(work, ignore_errors=True)
        return
    sums = [state_checksum(emb.stack_state(i))
            for i in range(len(emb.stacks))]
    path = str(work / "packed")
    checkpoint.save_checkpoint(path, model)
    nbytes = os.path.getsize(path)
    step(model.preprocess(dlrm_batch(slice_config(), seed + 50)))
    if [state_checksum(emb.stack_state(i))
            for i in range(len(emb.stacks))] == sums:
        fail("packed checkpoint: the extra step left the state as it was")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    checkpoint.restore_checkpoint(path, model)
    added_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    back = [state_checksum(emb.stack_state(i))
            for i in range(len(emb.stacks))]
    log(f"[checkpoint] packed 4M-cap state: {nbytes} bytes on disk "
        f"({state_bytes / 1e9:.2f} GB of tensors); restore added "
        f"{added_gb:.3f} GB of device memory; state checksums back "
        f"{back == sums}")
    shutil.rmtree(work, ignore_errors=True)
    if back != sums:
        fail("packed checkpoint: the restored state differs")
    if added_gb > 1.0:
        fail(f"packed checkpoint: restore added {added_gb:.2f} GB on the "
             "device")


def run_a13(dev, seed: int) -> None:
    """Phases 26-29. No kernel launches in 26-27; in 28 B1 once per step
    and stack of the schedule's DLRM (and none for the layers); in 29 one
    row kernel per ml_perf step and stack."""
    import torch

    reset_launch_counts()
    phase_gru4rec_small(dev, seed)
    phase_gru4rec(dev, seed)
    if any(launch_counts().values()):
        fail(f"gru4rec phases launched kernels: {launch_counts()}")
    model, step = phase_layers(dev, seed)
    phase_checkpoint(dev, model, step, seed)
    del model, step
    torch.cuda.empty_cache()



# --- Pipelined embedding and the walkthrough examples (phases 30-32) -------

#: Phase 30's own steps at full width: the unpipelined and the pipelined
#: loss per step over the same batches, from the same weights.
PIPE_STEPS = 8
#: The first steps of phase 30 (and all of phase 31's first batch steps):
#: the race check, each prefetch against a main-stream gather, bit for
#: bit, and B1 held to its plain version.
PIPE_RACE_STEPS = 3
#: |pipelined - unpipelined| loss per step over PIPE_STEPS: the one-step
#: staleness of the activations moves a loss near 0.69 by the size of
#: one Adagrad update of the rows (lr 0.0034); the largest gap read on an
#: H100 at seed 0 is 4.8e-6. What the steps compute is held bit for bit
#: to the same steps with the prefetch on the main stream
#: (held_to_main_stream), not by this bound.
PIPE_LOSS_BOUND = 1e-4
#: Elements per host-to-device chunk when a kept state is compared.
COMPARE_CHUNK = 1 << 26
SPLIT_FIXED_STEPS = 8
SPLIT_FRESH_STEPS = 3
EXAMPLE_RESUME = (6, 9, 3)  # steps, rerun to, checkpoint_every


def bits(t):
    """`t` viewed as integers of its width: equal views are equal bits."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@contextlib.contextmanager
def scatter_held_to_plain():
    """While open, every row scatter of the split update
    (scatter_rows_unique_multi: B3 for the table alone, B4 for the table
    with slots) is held to its plain version: before the launch each
    table is copied with one spare row and the copy takes
    `dst[idx[i]] = src[i]` for the live i < n_valid (the dead positions
    write the spare row); after the kernel the whole table equals the
    copy without its spare row, bit for bit, so a write to a dead
    position's destination or to any row outside idx shows. Yields a
    list with one 0-dim device tensor per call (the count of differing
    elements over its tables), read once the steps are done: the check
    makes no host read inside the step."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import lookup

    launch = lookup.scatter_rows_unique_multi
    calls: list = []

    def held(tables, idx, rows_list, n_valid=None):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)  # the check's own work
        n = idx.shape[0]
        live = torch.arange(n, device=idx.device) < (
            n if n_valid is None else n_valid.reshape(()))
        wants = []
        for table, rows in zip(tables, rows_list):
            want = torch.empty((table.shape[0] + 1, *table.shape[1:]),
                               dtype=table.dtype, device=table.device)
            want[:-1].copy_(table)
            want.index_copy_(0, torch.where(live, idx.long(), table.shape[0]),
                             rows.to(table.dtype))
            wants.append(want)
        torch.cuda.set_sync_debug_mode(mode)
        out = launch(tables, idx, rows_list, n_valid)
        torch.cuda.set_sync_debug_mode(0)
        calls.append(sum((bits(t) != bits(w[:-1])).sum()
                         for t, w in zip(tables, wants)))
        del wants
        torch.cuda.set_sync_debug_mode(mode)
        return out

    lookup.scatter_rows_unique_multi = held
    try:
        yield calls
    finally:
        lookup.scatter_rows_unique_multi = launch


@contextlib.contextmanager
def split_held_to_plain():
    """While open, every call of the split update's kernel (the lookup's
    apply_split_rows and round_split_rows) is held to its plain version:
    before the launch the plain version runs on a copy of the
    accumulator; after it the live rows of the two bf16 buffers and the
    two whole accumulators must be equal, bit for bit. Yields a list with
    one 0-dim device tensor per call (the count of differing elements),
    read once the steps are done: the check makes no host read inside
    the step."""
    import torch

    from keras_rs_tpu_torch.layers.embedding import lookup
    from keras_rs_tpu_torch.ops import row_ops

    launch_apply, launch_round = (lookup.apply_split_rows,
                                  lookup.round_split_rows)
    calls: list = []

    def differing(out, want, n_valid):
        live = torch.arange(out.shape[0], device=out.device) < (
            n_valid.reshape(()))
        return ((bits(out) != bits(want)) & live[:, None]).sum()

    def held_apply(table, acc, idx, grads, scalars, optimizer, n_valid,
                   seed):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)  # the check's own work
        want_acc = acc.clone()
        want = row_ops.apply_split_rows_reference(
            table, want_acc, idx, grads, scalars, optimizer, n_valid, seed)
        torch.cuda.set_sync_debug_mode(mode)
        out = launch_apply(table, acc, idx, grads, scalars, optimizer,
                           n_valid, seed)
        torch.cuda.set_sync_debug_mode(0)
        calls.append(differing(out, want, n_valid)
                     + (bits(acc) != bits(want_acc)).sum())
        del want, want_acc
        torch.cuda.set_sync_debug_mode(mode)
        return out

    def held_round(rows, idx, scalars, n_valid, seed):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        want = row_ops.round_split_rows_reference(rows, idx, scalars,
                                                  n_valid, seed)
        torch.cuda.set_sync_debug_mode(mode)
        out = launch_round(rows, idx, scalars, n_valid, seed)
        torch.cuda.set_sync_debug_mode(0)
        calls.append(differing(out, want, n_valid))
        del want
        torch.cuda.set_sync_debug_mode(mode)
        return out

    lookup.apply_split_rows = held_apply
    lookup.round_split_rows = held_round
    try:
        yield calls
    finally:
        lookup.apply_split_rows = launch_apply
        lookup.round_split_rows = launch_round


@contextlib.contextmanager
def scatter_and_split_held_to_plain():
    """scatter_held_to_plain and split_held_to_plain at once; yields
    their two lists."""
    with scatter_held_to_plain() as scatters, \
            split_held_to_plain() as splits:
        yield scatters, splits


@contextlib.contextmanager
def prefetch_on_main_stream():
    """While open, the pipelined step's side stream is the current
    stream (the pipelined module's `torch.cuda.Stream(device)` gives
    `torch.cuda.current_stream(device)`): every kernel of the step runs
    in program order."""
    import torch

    from keras_rs_tpu_torch.training import pipelined

    class Cuda:
        def __getattr__(self, name):
            return getattr(torch.cuda, name)

        @staticmethod
        def Stream(device):
            return torch.cuda.current_stream(device)

    class Torch:
        cuda = Cuda()

        def __getattr__(self, name):
            return getattr(torch, name)

    pipelined.torch = Torch()
    try:
        yield
    finally:
        pipelined.torch = torch


def held_to_main_stream(label: str, build, n_steps: int) -> dict:
    """The side-stream pipelined run held, bit for bit, to the same steps
    with the prefetch on the main stream (prefetch_on_main_stream): the
    loss of every step and, after the last, the model's whole state
    (stacked tables, optimizer slots, step counters, dense parameters),
    the dense optimizer's state and the last prefetch. Both runs take
    PyTorch's deterministic algorithms (warn_only: the lookup's gradient
    sum by row, `index_add_`, adds with atomics otherwise; B1 and the row
    scatter write each row once). `build()` gives (state, step, batches,
    get_pre) anew from the same seed; step t feeds batches[t] and
    prefetches batches[t + 1] (the last step its own). The side-stream
    run's state waits in host memory and is compared in chunks of
    COMPARE_CHUNK elements. Fails on any difference; returns the losses
    and the count of compared elements."""
    import torch

    from keras_rs_tpu_torch.training.train_state import map_tensors

    def run():
        state, step, batches, get_pre = build()
        losses = []
        before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for t in range(n_steps):
                nxt = get_pre(batches[min(t + 1, len(batches) - 1)])
                state, loss = step(state, batches[t], nxt)
                losses.append(loss)
        finally:
            torch.use_deterministic_algorithms(before)
        torch.cuda.synchronize()
        found = {f"model.{k}": v
                 for k, v in state.model.state_dict().items()}
        slots: list = []
        map_tensors(state.optimizer.state_dict(), slots.append)
        found.update({f"optimizer.{i}": v for i, v in enumerate(slots)})
        found.update({f"prefetch.{k}": v
                      for k, v in state.prefetched.acts.items()})
        return [float(x) for x in losses], found

    side_losses, found = run()
    kept = {k: v.detach().to("cpu") for k, v in found.items()}
    del found
    torch.cuda.empty_cache()
    with prefetch_on_main_stream():
        main_losses, found = run()
    differ, elements = {}, 0
    for k, v in found.items():
        host = kept.pop(k, None)
        if host is None or host.shape != v.shape or host.dtype != v.dtype:
            differ[k] = "shape or dtype"
            continue
        flat, hflat = v.reshape(-1), host.reshape(-1)
        bad = 0
        for i in range(0, flat.numel(), COMPARE_CHUNK):
            chunk = hflat[i:i + COMPARE_CHUNK].to(v.device)
            bad += int((bits(chunk) != bits(flat[i:i + COMPARE_CHUNK])).sum())
        elements += flat.numel()
        if bad:
            differ[k] = bad
    differ.update({k: "missing" for k in kept})
    del found, kept
    torch.cuda.empty_cache()
    log(f"[{label} streams held] {n_steps} steps, side stream against the "
        f"main stream, deterministic algorithms: losses {side_losses} "
        f"against {main_losses}; final state {elements} elements compared "
        f"bit for bit, differing {differ or 0}")
    if side_losses != main_losses or differ:
        fail(f"{label}: the side-stream run differs from the main-stream "
             f"run: losses {side_losses} against {main_losses}, state "
             f"{differ}")
    return {"losses": side_losses, "elements": elements}


def race_checked_step(pstep, state, batch, nxt, embed_fn, checks: list):
    """One pipelined step, its prefetch held to a gather of the same
    next batch enqueued on the main stream before the step: the count of
    differing elements goes into `checks` as a device tensor."""
    from keras_rs_tpu_torch.training import pipelined

    ref = pipelined.prime(state.model, nxt, embed_fn).acts
    state, loss = pstep(state, batch, nxt)
    checks.append(sum((state.prefetched.acts[k] != ref[k]).sum()
                      for k in ref))
    return state, loss


def run_pipelined(dev, seed: int) -> None:
    """Phase 30: pipelined embedding in the ml_perf entry point at full
    width, device preprocessing (packed f32 + Adagrad at the 4M cap,
    batch 16,384). `main(..., pipeline_embedding=True)` for MLPERF_STEPS
    steps and main's chained-step window (honest_timing); then, from the
    same weights over the same PIPE_STEPS batches, the unpipelined and
    the pipelined step: step 0's losses equal, every loss within
    PIPE_LOSS_BOUND, the first PIPE_RACE_STEPS prefetches equal to a
    main-stream gather bit for bit with each B1 call held to its plain
    version, B1 once per step and stack and no other launch, no host
    sync in a step (sync-debug "error"); last, the same PIPE_STEPS steps
    under deterministic algorithms held bit for bit to the prefetch on
    the main stream (held_to_main_stream)."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.training import pipelined
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    capped = [min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = mlperf.main("full_criteo", device=dev, num_steps=MLPERF_STEPS,
                    vocab_sizes=capped, device_preprocessing=True,
                    pipeline_embedding=True, honest_timing=True)
    counts = launch_counts()
    want_b1 = MLPERF_STEPS + MLPERF_TIMING_STEPS
    want = {k: want_b1 if k == "apply_scatter_row_blocks" else 0
            for k in counts}
    log(f"[launches] phase 30 pipelined main: {counts}")
    if counts != want:
        fail(f"pipelined mlperf: launches {counts}, expected {want}")
    if not main_results_ok(r, timed=True):
        fail(f"pipelined mlperf: results {r}")
    log(f"[pipelined mlperf] results {r}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    cfg = configs.full_criteo(vocab_sizes=capped)
    raws = list(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(
            PIPE_STEPS + 1, seed=seed + 30))
    model = mlperf.build_model(cfg, dev)
    step = make_train_step(model, mlperf.make_loss_fn(True),
                           DenseAdagrad(model.parameters(),
                                        cfg.learning_rate))
    plain_losses = [float(step(model.to_device(b)))
                    for b in raws[:PIPE_STEPS]]
    del model, step
    torch.cuda.empty_cache()

    def build():
        model = mlperf.build_model(cfg, dev)
        opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
        embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
        batches = [model.to_device(b) for b in raws]
        state = pipelined.create_pipelined_train_state(
            model, opt, get_pre(batches[0]), embed_fn)
        pstep = pipelined.make_pipelined_train_step(bce_loss, opt, embed_fn,
                                                    get_pre, inject)
        return state, pstep, batches, get_pre

    state, pstep, batches, get_pre = build()
    model = state.model
    embed_fn = mlperf.pipeline_fns(model, True)[0]
    n_stacks = len(model.embedding_layer.stacks)
    reset_launch_counts()
    losses, races = [], []
    with b1_held_to_plain() as b1_calls:
        for i in range(PIPE_RACE_STEPS):
            state, loss = race_checked_step(
                pstep, state, batches[i], get_pre(batches[i + 1]),
                embed_fn, races)
            losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # One step with every host sync an error.
        state, loss = pstep(state, batches[PIPE_RACE_STEPS],
                            get_pre(batches[PIPE_RACE_STEPS + 1]))
    except RuntimeError as e:
        fail(f"pipelined step: a host sync in sync-debug 'error': {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(loss)
    for i in range(PIPE_RACE_STEPS + 1, PIPE_STEPS):
        state, loss = pstep(state, batches[i], get_pre(batches[i + 1]))
        losses.append(loss)
    counts = launch_counts()
    losses = [float(x) for x in losses]
    races = [int(x) for x in races]
    b1 = [{k: float(v) for k, v in c.items()} for c in b1_calls]
    gaps = [abs(a - b) for a, b in zip(losses, plain_losses)]
    log(f"[launches] phase 30 pipelined steps: {counts}")
    log(f"[pipelined] {PIPE_STEPS} steps at batch {BATCH}: losses "
        f"{losses} against unpipelined {plain_losses} from the same "
        f"weights: gaps {gaps} (step 0 equal: {gaps[0] == 0.0}; bound "
        f"{PIPE_LOSS_BOUND}); prefetch against a main-stream gather, "
        f"elements differing per step {races}; B1 against its plain "
        f"version per call {b1}; step {PIPE_RACE_STEPS} ran in "
        f"sync-debug 'error' (0 host syncs)")
    if gaps[0] != 0.0:
        fail(f"pipelined step 0 differs from the unpipelined step 0: "
             f"{gaps[0]}")
    if (not all(map(math.isfinite, losses))
            or max(gaps) > PIPE_LOSS_BOUND):
        fail(f"pipelined losses do not track the unpipelined run: {gaps}")
    if any(races):
        fail(f"pipelined prefetch differs from the main-stream gather: "
             f"{races}")
    if len(b1) != PIPE_RACE_STEPS * n_stacks or any(c["bad"] for c in b1):
        fail(f"pipelined B1 calls against the plain version: {b1}")
    want = {k: PIPE_STEPS * n_stacks if k == "apply_scatter_row_blocks"
            else 0 for k in counts}
    if counts != want:
        fail(f"pipelined steps: launches {counts}, expected {want}")
    del model, state, pstep, batches
    torch.cuda.empty_cache()
    held_to_main_stream("pipelined", build, PIPE_STEPS)


def run_pipelined_split(dev, seed: int) -> None:
    """Phase 31: the pipelined step in the split layout, bf16 tables with
    row-wise Adagrad at the 4M cap, device preprocessing: 8 steps on one
    batch (loss falls), 3 fresh; the first PIPE_RACE_STEPS race-checked,
    every row scatter and every split kernel call held to its plain
    version; B3 and the split kernel once per step and stack, no other
    launch; the host syncs of one step (none expected: the rounding's
    bits come from the step counter on the device); last, the same steps under deterministic algorithms held bit for bit to the
    prefetch on the main stream (held_to_main_stream)."""
    import torch

    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.training import pipelined
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad

    cfg = slice_config(table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad")
    raws = ([dlrm_batch(cfg, seed)] * SPLIT_FIXED_STEPS
            + [dlrm_batch(cfg, seed + 1 + s)
               for s in range(SPLIT_FRESH_STEPS)])

    def build():
        model = build_dlrm("pipelined split", cfg, seed)
        opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
        embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
        order = [model.to_device(r) for r in raws]
        state = pipelined.create_pipelined_train_state(
            model, opt, get_pre(order[0]), embed_fn)
        pstep = pipelined.make_pipelined_train_step(bce_loss, opt, embed_fn,
                                                    get_pre, inject)
        return state, pstep, order, get_pre

    state, pstep, order, get_pre = build()
    model = state.model
    embed_fn = mlperf.pipeline_fns(model, True)[0]
    (stack,) = model.embedding_layer.stacks
    if stack.packed_state or stack.dtype != "bfloat16":
        fail("pipelined split: the stack is not a bf16 split stack")
    fresh = order[SPLIT_FIXED_STEPS:]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, races = [], []
    with scatter_held_to_plain() as scatters, \
            split_held_to_plain() as splits:
        for i, batch in enumerate(order):
            nxt = get_pre(order[min(i + 1, len(order) - 1)])
            if i < PIPE_RACE_STEPS:
                state, loss = race_checked_step(pstep, state, batch, nxt,
                                                embed_fn, races)
            else:
                state, loss = pstep(state, batch, nxt)
            losses.append(loss)
    counts = launch_counts()
    losses = [float(x) for x in losses]
    races = [int(x) for x in races]
    scatters = [int(x) for x in scatters]
    splits = [int(x) for x in splits]
    n = len(order)
    log(f"[launches] phase 31 pipelined split: {counts}")
    log(f"[pipelined split] {n} steps: losses {losses}; prefetch against a "
        f"main-stream gather, elements differing {races}; row scatters "
        f"against the plain version, elements differing per call "
        f"{scatters}; split kernel against its plain version (rows and "
        f"accumulators), elements differing per call {splits}; step counter "
        f"{float(model.embedding_layer.stack_state(0)['step'])}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not all(map(math.isfinite, losses)):
        fail(f"pipelined split: non-finite losses {losses}")
    if not losses[SPLIT_FIXED_STEPS - 1] < losses[0]:
        fail(f"pipelined split: loss did not fall on the fixed batch: "
             f"{losses}")
    if (any(races) or len(scatters) != n or any(scatters)
            or len(splits) != n or any(splits)):
        fail(f"pipelined split: race {races}, scatters {scatters}, split "
             f"kernel {splits}")
    want = {k: n if k in ("scatter_rows", "apply_split_rows") else 0
            for k in counts}
    if counts != want:
        fail(f"pipelined split: launches {counts}, expected {want}")
    sites = sync_sites(lambda: pstep(state, fresh[-1], get_pre(fresh[-1])))
    log(f"[pipelined split] host syncs of one step: {len(sites)} {sites}")
    del model, state, pstep, fresh, order
    torch.cuda.empty_cache()
    held_to_main_stream("pipelined split", build,
                        SPLIT_FIXED_STEPS + SPLIT_FRESH_STEPS)


WALKTHROUGHS = [
    # (module, the line the JAX example test greps for, gate of the
    # headline number, what it is)
    ("basic_ranking", "test RMSE", lambda x: 0.0 < x < 0.5,
     "held-out RMSE below 0.5 (mean predictor ~0.93)"),
    ("basic_retrieval", "serving export round-trip OK",
     lambda x: 0.2 < x <= 1.0, "recall@10 above 0.2 (popularity ~0.12)"),
    ("listwise_ranking", "NDCG@5", lambda x: 0.8 < x <= 1.0,
     "best NDCG@5 above 0.8 (a random ranking ~0.75)"),
    ("multi_task", "rating RMSE", lambda x: 0.0 < x < 1.0,
     "joint rating RMSE below 1.0"),
    ("deep_recommender", "recall@10", lambda x: 0.1 < x <= 1.0,
     "recall@10 above 0.1"),
    ("sas_rec", "recall", lambda x: 0.06 < x <= 1.0,
     "recall@10 above 0.06 (popularity ~0.03)"),
]


def run_walkthroughs(dev) -> None:
    """Phase 32: the six walkthrough examples on the card at their
    default sizes, each printout kept and its headline gated (the CPU
    test's range, and the bound named in WALKTHROUGHS), no kernel
    launched (SASRec at T 20 takes the einsum path); then the ml_perf
    entry point's pipelined resume, its launch counts zeroed just before:
    6 steps with checkpoint_every 3, a rerun to 9 that logs "resumed from
    checkpoint step 6" with finite losses, one row kernel per step and
    stack, each row scatter held to its plain version
    (scatter_held_to_plain)."""
    import importlib
    import io
    import shutil

    import torch

    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf

    reset_launch_counts()
    for name, expect, gate, what in WALKTHROUGHS:
        module = importlib.import_module(f"keras_rs_tpu_torch.examples.{name}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            headline = module.main(dev)
        for line in out.getvalue().splitlines():
            log(f"[example {name}] {line}")
        log(f"[example {name}] headline {headline!r}; gate: {what}")
        if expect not in out.getvalue():
            fail(f"example {name}: no '{expect}' line")
        if not (math.isfinite(headline) and gate(headline)):
            fail(f"example {name}: headline {headline} fails '{what}'")
        torch.cuda.empty_cache()
    counts = launch_counts()
    log(f"[launches] phase 32 examples: {counts}")
    if any(counts.values()):
        fail(f"the walkthrough examples launched kernels: {counts}")

    work = SMOKE_DIR / "pipelined_resume"
    shutil.rmtree(work, ignore_errors=True)
    messages: list[str] = []

    class Collect(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Collect()
    logging.getLogger("ml_perf").addHandler(handler)
    steps, rerun_to, every = EXAMPLE_RESUME
    n_stacks = len(mlperf.build_model(configs.smoke_test(),
                                      dev).embedding_layer.stacks)
    runs, logs = [], []
    reset_launch_counts()
    try:
        with scatter_held_to_plain() as scatters:
            for num_steps in (steps, rerun_to):
                del messages[:]
                runs.append(mlperf.main(
                    "smoke_test", device=dev, num_steps=num_steps,
                    checkpoint_dir=str(work / "ck"), checkpoint_every=every,
                    pipeline_embedding=True))
                logs.append(list(messages))
    finally:
        logging.getLogger("ml_perf").removeHandler(handler)
    counts = launch_counts()
    scatters = [int(x) for x in scatters]
    saved = sorted(os.listdir(work / "ck"))
    shutil.rmtree(work, ignore_errors=True)
    row = sum(counts[k] for k in ROW_KERNELS)
    log(f"[launches] phase 32 pipelined resume: {counts}")
    log(f"[pipelined resume] ml_perf smoke_test, pipelined: {steps} steps "
        f"with checkpoint_every {every}, then a rerun to {rerun_to}: losses "
        f"{[x['loss'] for x in runs]}; checkpoints {saved}; the rerun "
        f"logged {[m for m in logs[1] if 'resumed' in m]}; row scatters "
        f"against the plain version, elements differing per call "
        f"{scatters}")
    if len(scatters) != rerun_to * n_stacks or any(scatters):
        fail(f"pipelined resume: row scatters against the plain version "
             f"{scatters}, expected {rerun_to * n_stacks} calls, all 0")
    if any("resumed" in m for m in logs[0]) or not any(
            f"resumed from checkpoint step {steps}" in m for m in logs[1]):
        fail("pipelined resume: the rerun did not resume")
    if not all(math.isfinite(x["loss"]) for x in runs):
        fail(f"pipelined resume: losses {runs}")
    if row != rerun_to * n_stacks or any(counts[k] for k in FLASH_KERNELS):
        fail(f"pipelined resume: launches {counts}, expected one row "
             f"kernel per step and stack ({rerun_to * n_stacks})")


# --- phase 32b: the benchmark entry point --------------------------------

#: bench.py's keys, and those of its pipelined and flagship variants.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "step_ms",
              "dense_ms", "embedding_floor_ms", "mfu_dense", "embedding_ms",
              "embedding_floor_frac")
BENCH_PIPELINED_KEYS = ("pipelined_examples_per_sec", "pipelined_step_ms")
BENCH_FLAGSHIP_KEYS = ("flagship_examples_per_sec", "flagship_step_ms",
                       "flagship_entries_per_batch", "flagship_unique_rows",
                       "flagship_embedding_floor_ms")
#: The bf16 + row-wise Adagrad mix (kernel B3), without the naive and
#: flagship runs.
BENCH_CAPACITY_ENV = {"BENCH_TABLE_DTYPE": "bfloat16",
                      "BENCH_EMB_OPTIMIZER": "rowwise_adagrad",
                      "BENCH_SKIP_NAIVE": "1", "BENCH_FLAGSHIP": "0"}


def bench_line(label: str, env: dict, keys, expect: dict) -> None:
    """keras_rs_tpu_torch.bench.main() in this process under `env`, its
    launch counts zeroed just before and read just after; its stdout
    kept, its last line parsed and checked. bench.py reads its knobs from
    os.environ. `expect` holds the launches of its steps run eagerly, one
    per step of a kernel's models: the steps that replayed a graph of a
    model with stacked tables (training/train_state.StepGraph) launched
    none through their wrappers, and there must be some."""
    import io
    from unittest import mock

    from keras_rs_tpu_torch import bench

    graphs = []  # the StepGraph counts of bench's stacked models

    def make_train_step(model, *args, **kwargs):
        step = real_make_train_step(model, *args, **kwargs)
        layer = getattr(model, "embedding_layer", None)
        if layer is not None and layer.has_sharded_tables():
            graphs.append(step.graphs.counts)
        return step

    real_make_train_step = bench.make_train_step
    out = io.StringIO()
    reset_launch_counts()
    with (mock.patch.dict(os.environ, env),
          mock.patch.object(bench, "make_train_step", make_train_step),
          contextlib.redirect_stdout(out)):
        bench.main()
    counts = launch_counts()
    replayed = sum(c["replays"] - c["captures"] for c in graphs)
    if not replayed > 0:
        fail(f"bench {label}: no step replayed a graph ({graphs})")
    expect = {k: n - replayed if n else 0 for k, n in expect.items()}
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f"[bench {label}] {line}")
    result = json.loads(lines[-1])
    log(f"[bench {label}] {json.dumps(result)}")
    log(f"[launches] phase 32b bench, {label}: {counts}; {replayed} "
        f"steps only replayed a graph")
    if counts != expect:
        fail(f"bench {label}: launches {counts}, expected {expect}")
    missing = [k for k in keys if k not in result]
    errors = {k: v for k, v in result.items()
              if k == "error" or k.endswith("_error")}
    if missing or errors:
        fail(f"bench {label}: missing keys {missing}, errors {errors}")
    if not result["value"] > 0:
        fail(f"bench {label}: value {result['value']}")
    for k in ("mfu_dense", "embedding_floor_frac"):
        v = result[k]
        if not (isinstance(v, (int, float)) and 0 < v <= 1):
            fail(f"bench {label}: {k} {v} outside (0, 1]")
    # embedding_floor_frac is clamped to 1: a floor that counts too many
    # bytes shows only in the raw ratio.
    ratio = result["embedding_floor_ms"] / result["embedding_ms"]
    if ratio > 1.05:
        fail(f"bench {label}: embedding_floor_ms / embedding_ms = {ratio}")
    if ("flagship_step_ms" in result and not result[
            "flagship_embedding_floor_ms"] < result["flagship_step_ms"]):
        fail(f"bench {label}: the flagship's floor "
             f"{result['flagship_embedding_floor_ms']} ms is not below its "
             f"step {result['flagship_step_ms']} ms")


def run_bench(dev) -> None:
    """Phase 32b: the benchmark entry point, each kernel's calls in one
    untimed step of every model bench.main() times with it (ours,
    pipelined and flagship for B1; ours in the bf16 + row-wise Adagrad
    mix for B3) held to the plain version at the shapes main gives it,
    then bench.main() in the packed f32 + Adagrad mix with its pipelined
    and flagship variants, and in the bf16 + row-wise Adagrad mix."""
    import gc
    from unittest import mock

    import torch

    from keras_rs_tpu_torch import bench

    iters = int(os.environ.get("BENCH_ITERS", 20))
    blocks = int(os.environ.get("BENCH_BLOCKS", 5))
    ours = iters * (blocks + 1) + iters  # timed blocks + the busy block
    expect = {k: 0 for k in launch_counts()}

    def held_step(label: str, env: dict, make, held, check) -> None:
        """One step of the model `make()` builds under `env`, the
        kernel's calls held by `held`."""
        with mock.patch.dict(os.environ, env):
            step, batch = make()
        with held() as calls:
            step(batch)
        torch.cuda.synchronize()
        got = check(calls)
        log(f"[bench held] {label}: {got}")
        del step, batch, calls
        gc.collect()
        torch.cuda.empty_cache()

    def make_ours():
        return bench.build("sharded", 8192, 4_000_000, 128, device=dev)[1:3]

    def make_pipelined():
        return bench.build_pipelined(8192, 4_000_000, 128, device=dev)

    def make_flagship():
        fv, fm, _, max_u = bench.flagship_shape(8192)
        return bench.build("sharded", 8192, 4_000_000, 128, vocab_sizes=fv,
                           multi_hot_sizes=fm, max_unique=max_u,
                           device=dev)[1:3]

    def b1_check(calls):
        if len(calls) != 1 or any(bool(c["bad"]) for c in calls):
            fail(f"bench: B1 calls of one step against the plain version: "
                 f"{calls}")
        return (f"{len(calls)} B1 call, max_abs_err "
                f"{[float(c['err']) for c in calls]} (phase 2's bound)")

    def b3_check(calls):
        differing = [int(c) for c in calls]
        if len(differing) != 1 or any(differing):
            fail(f"bench: B3 calls of one step against the plain version: "
                 f"elements differing {differing}")
        return f"{len(differing)} B3 call, elements differing {differing}"

    def b3_split_check(calls):
        scatters, splits = calls
        differing = [int(c) for c in splits]
        if len(differing) != 1 or any(differing):
            fail(f"bench: split kernel calls of one step against the plain "
                 f"version: elements differing {differing}")
        return (f"{b3_check(scatters)}; {len(differing)} split kernel "
                f"call, elements differing {differing}")

    for label, make in (("packed f32 + Adagrad", make_ours),
                        ("pipelined", make_pipelined),
                        ("flagship", make_flagship)):
        held_step(label, {}, make, b1_held_to_plain, b1_check)
    bench_line(
        "packed f32 + Adagrad", {"BENCH_PIPELINE": "1"},
        BENCH_KEYS + BENCH_PIPELINED_KEYS + BENCH_FLAGSHIP_KEYS,
        dict(expect, apply_scatter_row_blocks=(
            ours + iters * (blocks + 1) + iters * (max(3, blocks - 2) + 1))))
    held_step("bf16 + row-wise Adagrad", BENCH_CAPACITY_ENV, make_ours,
              scatter_and_split_held_to_plain, b3_split_check)
    bench_line("bf16 + row-wise Adagrad", BENCH_CAPACITY_ENV, BENCH_KEYS,
               dict(expect, scatter_rows=ours, apply_split_rows=ours))


# --- phases 33-36: the sharded embedding over two ranks on one card ------

SHARD_RANKS = 2
#: Phase 34's comparison with one device: full widths and batch, each
#: vocabulary capped here (a D = 1 copy beside the two shards of each
#: rank); the timed run keeps VOCAB_CAP.
SHARD_COMPARE_CAP = 500_000
#: The comparison's learning rate: one step moves every table by far
#: more than its f32 spacing (the config's 0.0034 moves the large
#: tables' rows by less than one ulp).
SHARD_COMPARE_LR = 0.05
#: f32 bound of the D = 2 forward against D = 1 (activations, logits):
#: |d| <= 1e-4 * max(1, |D = 1|). The exchanges add in another order.
SHARD_F32_BOUND = 1e-4
#: Bounds of what one cotangent changes (Δ = after - before) through
#: apply_cotangents at D = 2 against D = 1: per element 1e-3 of the
#: table's largest |Δ| plus 4 ulp of the value, and 1e-4 in relative
#: L2 over all the tables (plus 1 ulp of each value that differs). A
#: row's gradient adds its few terms in another order; an update that
#: did nothing is off by 1, one that lost a rank's samples by ~0.7.
SHARD_DELTA_RTOL = 1e-3
SHARD_DELTA_L2 = 1e-4
SHARD_ULPS = 4
#: A whole training step's Δ against D = 1's, over all the tables and
#: over all the dense parameters, in relative L2: the dense stack sums
#: in another order at half the batch, which flips the ReLUs of the few
#: samples whose pre-activation is ~0, and their gradients (each row
#: hit by them, each dense parameter's sum) move by a few %.
SHARD_STEP_L2 = 1e-2
#: comm_dtype="bfloat16" rounds every exchanged value by up to 2^-9,
#: and the DCN stack of a random model turns that into a change of the
#: whole step's direction by ~8% in relative L2 (the bottom MLP's step,
#: which no bf16 exchange reaches in the backward, moves as much):
#: the gap of its Δ to the f32 exchange's within SHARD_BF16_L2 in
#: relative L2 over the tables and over the dense parameters (a step
#: that did nothing is off by 1); the norms of its
#: changes and the loss's fall within SHARD_BF16_RTOL
#: (tests/test_comm_dtype.py's rtol).
SHARD_BF16_L2 = 0.25
SHARD_BF16_RTOL = 2e-2
#: The loss's fall in one step at D = 2 against D = 1: 1e-2 of it plus
#: SHARD_ULPS ulp of the loss; D = 1's must exceed 64 ulp.
SHARD_LOSS_RTOL = 1e-2
SHARD_MLPERF_STEPS = 8
#: The entry point's chained device timing in the ranks: 2 blocks of 3
#: steps after a warm-up block (utils/timing.measure_step_time).
SHARD_TIMING = {"iters": 3, "blocks": 2}
SHARD_SPLIT_STEPS = 3
RANK_TIMEOUT_S = 420
#: What the probe runs on CUDA tensors under gloo, by the package's
#: collective that uses it (parallel/collectives.py) and the types the
#: path gives it.
PROBES = (("all_to_all", "int32"), ("reduce_scatter", "float32"),
          ("reduce_scatter", "bfloat16"), ("all_gather", "float32"),
          ("all_gather", "bfloat16"), ("all_reduce", "float32"))


def rlog(rank: int, msg: str) -> None:
    log(f"[rank {rank}] {msg}")


def _rank_main(rank: int, world: int, port: int, conn) -> None:
    """A rank of phases 33-36: cuda:0, a gloo group over localhost, then
    the cases the parent sends until it sends None."""
    import traceback

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format=f"[rank {rank}] [%(name)s] %(message)s",
                        force=True)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", globals()[name](rank, world, **kwargs)))
            except BaseException:  # sent to the parent, which fails
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class Ranks:
    """`world` spawned processes on cuda:0 in one gloo group. `run`
    calls a rank case on every rank under a timeout; a rank that raises
    or does not answer kills every rank and fails the script."""

    def __init__(self, world: int) -> None:
        import multiprocessing
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(rank, world, port, child))
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, name: str, **kwargs) -> list:
        for conn in self.conns:
            conn.send((name, kwargs))
        out, errors = [], []
        timeout = RANK_TIMEOUT_S
        for rank, conn in enumerate(self.conns):
            if not conn.poll(timeout):
                errors.append(f"rank {rank}: no answer in {timeout} s")
                break
            status, value = conn.recv()
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
                timeout = 30  # the others may wait for it in a collective
            out.append(value)
        if errors:
            self.close()
            fail(f"{name}:\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for conn, p in zip(self.conns, self.procs):
            if p.is_alive():
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(10)
        if any(p.is_alive() for p in self.procs):
            fail("a rank outlived its phase")


def rank_probe(rank: int, world: int) -> dict[str, str]:
    """Phase 33: each collective of the path on CUDA tensors under gloo,
    its result checked: "ok", or what it raised or returned."""
    import torch

    from keras_rs_tpu_torch.parallel import collectives

    dev = torch.device("cuda", 0)
    group = torch.distributed.group.WORLD
    out = {}
    for name, dtype_name in PROBES:
        dtype = getattr(torch, dtype_name)
        x = (torch.arange(world * 4, device=dev) + 100 * rank).to(dtype)
        base = torch.arange(world * 4)
        if name == "all_to_all":
            want = torch.cat([base[4 * rank : 4 * rank + 4] + 100 * j
                              for j in range(world)])
            run = lambda: collectives.all_to_all(x.view(world, 4), group)
        elif name == "reduce_scatter":
            want = world * base[4 * rank : 4 * rank + 4] + 100 * sum(
                range(world))
            run = lambda: collectives.reduce_scatter(x, group)
        elif name == "all_gather":
            want = torch.cat([base[:4] + 100 * j for j in range(world)])
            run = lambda: collectives.all_gather(x[:4], group)
        else:
            want = world * base + 100 * sum(range(world))
            run = lambda: collectives.all_reduce(x.clone(), group)
        key = f"{name}:{dtype_name}"
        try:
            got = run().reshape(-1).cpu()
            torch.cuda.synchronize()
            out[key] = ("ok" if torch.equal(got.double(), want.double())
                        else f"wrong result {got.tolist()}")
        except Exception as e:  # the probe's finding, reported
            out[key] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _rank_rows(batch: dict, rank: int, world: int) -> dict:
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n : (rank + 1) * n] for k, v in batch.items()}


def rank_compare(rank: int, world: int, seed: int) -> dict:
    """Phase 34, first part: the MLPerf DLRM-DCNv2 at full widths and
    batch (vocabularies capped at SHARD_COMPARE_CAP, f32 dense stack,
    learning rate SHARD_COMPARE_LR) sharded over the ranks against the
    same model at D = 1 in this rank, from the same seed and global
    batch: the rank's device COO against the single-process global
    transform at D = 2 (bit for bit), activations and logits (within
    SHARD_F32_BOUND); the sharded backward alone, one cotangent through
    apply_cotangents, held per element by what it changed in every
    all-gathered table (delta_errs, SHARD_DELTA_RTOL / SHARD_DELTA_L2);
    one training step held by what it changed in the tables and the
    dense parameters (SHARD_STEP_L2) and a second for the loss's fall
    (SHARD_LOSS_RTOL); and comm_dtype="bfloat16" for the same two steps
    against the f32 exchange (SHARD_BF16_L2, SHARD_BF16_RTOL)."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import configs
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
        preprocess_stack_device,
    )
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
    from keras_rs_tpu_torch.parallel import collectives
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    cfg = configs.full_criteo(vocab_sizes=[
        min(v, SHARD_COMPARE_CAP) for v in CRITEO_VOCAB_SIZES],
        learning_rate=SHARD_COMPARE_LR)
    meshes = {world: mesh_lib.create_mesh(dev),
              1: mesh_lib.Mesh(("data",), (1,), dev)}

    def build(D, comm_dtype=None):
        c = mlperf.model_config(cfg, D)
        c.compute_dtype = c.dense_output_dtype = None  # f32 dense stack
        c.embedding_comm_dtype = comm_dtype
        return DLRMDCNv2(
            c, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, mesh=meshes[D])

    ref, m2 = build(1), build(world)
    host = next(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(
            1, seed=seed + 5))
    glob = [ref.to_device(host)]
    loc = [m2.to_device(_rank_rows(host, rank, world))]
    n = cfg.global_batch_size // world
    rows = slice(rank * n, (rank + 1) * n)

    # The rank's COO against the global transform at D = 2.
    (stack,) = m2.embedding_layer.stacks
    large = [f"cat_{i}" for i in m2.large_idx]
    g_coo, _ = preprocess_stack_device(
        stack, {k: glob[0][k] for k in large})
    r_coo, _ = preprocess_stack_device(
        stack, {k: loc[0][k] for k in large}, shard=rank,
        group=m2.embedding_layer._group)
    pairs = {
        "send_slots": (r_coo.send_slots[0], g_coo.send_slots[rank]),
        "send_segs": (r_coo.send_segs[0], g_coo.send_segs[rank]),
        "send_gains": (r_coo.send_gains[0], g_coo.send_gains[rank]),
        "recv_slots": (r_coo.recv_slots, g_coo.send_slots[:, rank]),
        "recv_segs": (r_coo.recv_segs, g_coo.send_segs[:, rank]),
        "recv_gains": (r_coo.recv_gains, g_coo.send_gains[:, rank]),
        "unique_slots": (r_coo.unique_slots[0], g_coo.unique_slots[rank]),
        "entry_unique": (r_coo.entry_unique[0], g_coo.entry_unique[rank]),
    }
    for k, (a, b) in pairs.items():
        if not torch.equal(bits(a), bits(b)):
            fail(f"rank {rank}: COO {k} differs from the global transform")
    n_ids = int((r_coo.send_slots != stack.sink_slot).sum())
    del g_coo, r_coo

    def err(a, b) -> float:
        a, b = a.detach().float(), b.detach().float()
        d = (a - b).abs()
        bad = d > SHARD_F32_BOUND * b.abs().clamp(min=1.0)
        if bool(bad.any()):
            fail(f"rank {rank}: {int(bad.sum())} values over the f32 "
                 f"bound; worst {float(d.max())!r}")
        return float(d.max())

    errs: dict[str, float] = {}
    pre1 = ref.embedding_layer.preprocess_on_device(
        {k: glob[0][k] for k in large})
    pre2 = m2.embedding_layer.preprocess_on_device(
        {k: loc[0][k] for k in large})
    with torch.no_grad():
        a1, a2 = ref.embedding_layer(pre1), m2.embedding_layer(pre2)
        errs["activations"] = max(err(a2[k], a1[k][rows]) for k in large)
        del a1, a2
        errs["logits"] = err(m2(m2.preprocess_on_device(loc[0])),
                             ref(ref.preprocess_on_device(glob[0]))[rows])

    def loss_fn(m, b):
        from keras_rs_tpu_torch.models.dlrm import bce_loss
        return bce_loss(m, m.preprocess_on_device(b))

    def fit(m, mesh=None):
        return make_train_step(m, loss_fn, DenseAdagrad(m.parameters(),
                                                        cfg.learning_rate),
                               mesh=mesh)

    def state(m, dense=True):
        """The all-gathered tables and (with `dense`) the dense
        parameters, copied."""
        out = dict(m.embedding_layer.get_embedding_tables())
        if dense:
            out.update((f"dense {n}", p.detach().clone())
                       for n, p in m.named_parameters())
        return out

    def ulp(x):
        a = x.abs()
        return torch.nextafter(a, torch.full_like(a, math.inf)) - a

    def delta_errs(b_got, a_got, b_want, a_want, rtol, l2) -> dict:
        """What one update changed, Δ = after - before, against the
        reference's. Over all the tables together, and over all the
        dense parameters, the gap within `l2` of the reference's |Δ| in
        L2 (plus 1 ulp of each value that differs: the rounding of a
        sum that moved across a rounding boundary); every tensor's
        reference Δ nonzero; with `rtol`, each element within rtol of
        its tensor's largest reference |Δ| plus SHARD_ULPS ulp of the
        value, the reference's Δ larger than that somewhere (so an
        update that changed nothing fails). Returns, for the tables and
        the dense parameters, the relative L2 gap, its share of the
        bound, the norm ratio |Δ| / |reference Δ| and, with `rtol`, the
        worst per-element share."""
        out: dict[str, float] = {}
        sums: dict[str, list[float]] = {}
        for k in a_want:
            d_want = a_want[k] - b_want[k]
            d_got = a_got[k] - b_got[k]
            spacing = SHARD_ULPS * ulp(a_want[k])
            gap = (d_got - d_want).abs()
            part = "dense" if k.startswith("dense ") else "tables"
            if not bool((d_want != 0).any()):
                fail(f"rank {rank}: {k}: the reference update left it as "
                     "it was")
            if rtol is not None:
                bound = rtol * float(d_want.abs().max()) + spacing
                if not bool((d_want.abs() > bound).any()):
                    fail(f"rank {rank}: {k}: the reference update's change "
                         f"is within the bound everywhere (largest "
                         f"{float(d_want.abs().max())!r})")
                share = float((gap / bound).max())
                if share > 1.0:
                    fail(f"rank {rank}: {k}: the change differs from the "
                         f"reference's by {float(gap.max())!r} ({share!r} "
                         f"of the bound)")
                out[f"{part} elem/bound"] = max(
                    out.get(f"{part} elem/bound", 0.0), share)
            acc = sums.setdefault(part, [0.0, 0.0, 0.0, 0.0])
            for j, t in enumerate((gap, d_want, d_got,
                                   torch.where(gap > 0, ulp(a_want[k]),
                                               0.0))):
                acc[j] += float(torch.linalg.vector_norm(t)) ** 2
        for part, (gap2, want2, got2, spacing2) in sums.items():
            bound = l2 * math.sqrt(want2) + math.sqrt(spacing2)
            out[f"{part} l2"] = math.sqrt(gap2 / want2)
            out[f"{part} l2/bound"] = math.sqrt(gap2) / bound
            out[f"{part} norm ratio"] = math.sqrt(got2 / want2)
            if out[f"{part} l2/bound"] > 1.0:
                fail(f"rank {rank}: the {part}' change differs from the "
                     f"reference's by {out[f'{part} l2']!r} in relative L2 "
                     f"(bound {l2} + 1 ulp of each value that differs)")
        return out

    # The sharded backward alone, row by row: the same cotangent of the
    # global batch's activations (normal / B from the seed) through
    # apply_cotangents at D = 1 and, each rank its rows, at D = 2. Every
    # row gathers the same at most few terms, so each element of what
    # it changed is held to SHARD_DELTA_RTOL.
    rng = np.random.default_rng(seed + 7)
    d_acts = {k: torch.from_numpy(rng.standard_normal(
        (cfg.global_batch_size, cfg.embedding_dim), dtype=np.float32)
        / cfg.global_batch_size).to(dev) for k in large}
    d_rows = {k: v[rows].clone() for k, v in d_acts.items()}
    before1, before2 = state(ref, False), state(m2, False)
    ref.embedding_layer.apply_cotangents(pre1, d_acts)
    m2.embedding_layer.apply_cotangents(pre2, d_rows)
    cotangent = delta_errs(before2, state(m2, False), before1,
                           state(ref, False), SHARD_DELTA_RTOL,
                           SHARD_DELTA_L2)
    del pre1, pre2, d_acts, before1, before2
    torch.cuda.empty_cache()

    # One training step at D = 1 and D = 2, held by what it changed (a
    # later step would start from this one's rounding and ReLU flips),
    # then a second whose loss is the one after the first on the same
    # batch: the loss's fall.
    step1, step2 = fit(ref), fit(m2, meshes[world])
    before1, before2 = state(ref), state(m2)
    losses = {"d1": [float(step1(glob[0]))]}
    with collectives.count_bytes() as step_bytes:
        losses["d2"] = [float(step2(loc[0]))]
    after2 = state(m2)
    moved = delta_errs(before2, after2, before1, state(ref), None,
                       SHARD_STEP_L2)
    del before1
    losses["d1"].append(float(step1(glob[0])))
    losses["d2"].append(float(step2(loc[0])))
    # comm_dtype="bfloat16": the same two steps from the same state (the
    # cotangent applied), held against the f32 exchange's at D = 2: the
    # first loss, what the first step changed, the loss's fall.
    mb = build(world, "bfloat16")
    mb.embedding_layer.apply_cotangents(
        mb.embedding_layer.preprocess_on_device(
            {k: loc[0][k] for k in large}), d_rows)
    stepb = fit(mb, meshes[world])
    b_b = state(mb)
    with collectives.count_bytes() as bf16_bytes:
        lb = [float(stepb(loc[0]))]
    bf16 = delta_errs(b_b, state(mb), before2, after2, None, SHARD_BF16_L2)
    lb.append(float(stepb(loc[0])))
    del mb, stepb, b_b, before2, after2
    torch.cuda.empty_cache()
    loss1, loss2 = losses["d1"], losses["d2"]
    spacing = SHARD_ULPS * float(ulp(torch.tensor(loss1[0])))
    if abs(loss2[0] - loss1[0]) > spacing:
        fail(f"rank {rank}: first losses {losses}")
    fall1, fall2 = loss1[1] - loss1[0], loss2[1] - loss2[0]
    if abs(fall1) <= 16 * spacing or abs(fall2 - fall1) > (
            SHARD_LOSS_RTOL * abs(fall1) + spacing):
        fail(f"rank {rank}: the step moved the loss by {fall2!r} at "
             f"D = 2 and {fall1!r} at D = 1: {losses}")
    # The bf16 exchange: its first loss within tests/test_comm_dtype.py's
    # 1e-2, its changes' norms and the loss's fall within
    # SHARD_BF16_RTOL of the f32 exchange's, its changes not equal to
    # them.
    fall_b = lb[1] - lb[0]
    bf16.update(loss=lb, loss_rel=abs(lb[0] - loss2[0]) / abs(loss2[0]),
                fall_rel=abs(fall_b - fall2) / abs(fall2))
    ratios = [bf16["tables norm ratio"], bf16["dense norm ratio"]]
    if (bf16["loss_rel"] >= 1e-2
            or abs(fall_b - fall2) > SHARD_BF16_RTOL * abs(fall2) + spacing
            or any(abs(r - 1) > SHARD_BF16_RTOL for r in ratios)
            or bf16["tables l2"] == 0.0 or bf16["dense l2"] == 0.0):
        fail(f"rank {rank}: the bf16 exchange's step against the f32 "
             f"one: {bf16}; f32 losses {loss2}")
    dense_params = sum(p.numel() for p in m2.parameters())
    S_l = stack.local_batch_size * stack.num_features
    C = stack.max_ids_per_partition
    # The counter against the closed form of the port's weak-scaling tool
    # (keras_rs_tpu_torch/tools/weak_scaling.py) at these shapes.
    for label, got, wire in (("f32", step_bytes, 4), ("bf16", bf16_bytes, 2)):
        want = {"all-to-all": world * 3 * C * 4,
                "reduce-scatter": S_l * cfg.embedding_dim * wire,
                "all-gather": world * S_l * cfg.embedding_dim * wire,
                "all-reduce": (dense_params + 1) * 4, "broadcast": 0}
        if got != want:
            fail(f"rank {rank}: the {label} step's collective bytes {got}, "
                 f"closed form {want}")
    out = {"ids": n_ids, "errs": errs, "cotangent": cotangent,
           "moved": moved, "losses": losses, "bf16": bf16,
           "bytes": {"f32": dict(step_bytes), "bf16": dict(bf16_bytes)}}
    rlog(rank, f"[compare] D = {world} against D = 1 at cap "
         f"{SHARD_COMPARE_CAP}, lr {SHARD_COMPARE_LR}: COO bit-exact "
         f"({n_ids} ids sent); forward max abs errors {errs}; the "
         f"cotangent's change of the tables against D = 1's {cotangent}; "
         f"the step's change against D = 1's {moved}; losses {losses}; "
         f"bf16 exchange against f32 {bf16}; collective bytes of one "
         f"training step, by kind: f32 {out['bytes']['f32']}, bf16 "
         f"exchange {out['bytes']['bf16']}")
    del ref, m2, step1, step2, glob, loc, d_rows
    torch.cuda.empty_cache()
    return out


def rank_mlperf(rank: int, world: int, seed: int,
                pipeline_embedding: bool = False) -> dict:
    """Phase 34, second part (and phase 37 with `pipeline_embedding`):
    the ml_perf entry point on this rank, main("full_criteo") at the 4M
    cap with device preprocessing and main's chained-step window
    (honest_timing, cut to SHARD_TIMING); launches counted from 0, every
    B1 call of the SHARD_MLPERF_STEPS training steps held to the plain
    version (the window's blocks run the kernel alone), peak memory."""
    import torch

    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.layers.embedding import lookup
    from keras_rs_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    capped = [min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES]
    measure = timing.measure_step_time
    launch = lookup.apply_scatter_row_blocks

    def unheld_timing(*args, **kwargs):
        held = lookup.apply_scatter_row_blocks
        lookup.apply_scatter_row_blocks = launch
        try:
            return measure(*args, **SHARD_TIMING, **kwargs)
        finally:
            lookup.apply_scatter_row_blocks = held

    timing.measure_step_time = unheld_timing
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        with b1_held_to_plain() as calls:
            r = mlperf.main("full_criteo", device=dev,
                            num_steps=SHARD_MLPERF_STEPS,
                            vocab_sizes=capped, device_preprocessing=True,
                            honest_timing=True,
                            pipeline_embedding=pipeline_embedding)
    finally:
        timing.measure_step_time = measure
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = SHARD_MLPERF_STEPS + SHARD_TIMING["iters"] * (
        SHARD_TIMING["blocks"] + 1)
    want = {k: steps if k == "apply_scatter_row_blocks" else 0
            for k in counts}
    if counts != want:
        fail(f"rank {rank}: sharded mlperf launches {counts}, expected "
             f"{want}")
    if len(calls) != SHARD_MLPERF_STEPS or any(bool(c["bad"])
                                               for c in calls):
        fail(f"rank {rank}: B1 against its plain version: "
             f"{[(float(c['err']), bool(c['bad'])) for c in calls]}")
    held = [float(c["err"]) for c in calls]
    if not main_results_ok(r, timed=True):
        fail(f"rank {rank}: results {r}")
    label = "pipelined mlperf" if pipeline_embedding else "mlperf"
    rlog(rank, f"[{label} D = {world}] results {r}; peak device memory {peak:.2f} GB; B1 launches "
         f"{counts['apply_scatter_row_blocks']}, the {len(held)} of the "
         f"training steps held to the plain version: max_abs_err "
         f"{held}")
    torch.cuda.empty_cache()
    return {"results": r, "counts": counts, "peak_gb": peak,
            "held_err": held}


def rank_split(rank: int, world: int, seed: int) -> dict:
    """Phase 35: the split layout at D = 2: bf16 tables with row-wise
    Adagrad at the 4M cap, device preprocessing, SHARD_SPLIT_STEPS
    data-parallel steps on one batch (the global loss falls), every
    row scatter (B3 on the rank's shard) held to its plain version on a
    copy of the whole shard and every split kernel call to its plain
    version, B3 and the split kernel once per step."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    cfg = slice_config(table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad")
    # The worst case per shard: every id of the rank's samples in one
    # bucket, and as many uniques per shard in all.
    cfg.max_ids_per_partition //= world
    cfg.max_unique_ids_per_partition //= world
    torch.cuda.reset_peak_memory_stats()
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev, mesh=mesh)
    (stack,) = model.embedding_layer.stacks
    if stack.packed_state or stack.dtype != "bfloat16":
        fail(f"rank {rank}: split stack expected, got {stack}")
    raw = next(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(1, seed=seed))
    batch = model.to_device(_rank_rows(raw, rank, world))
    step = make_train_step(model, mlperf.make_loss_fn(True),
                           DenseAdagrad(model.parameters(),
                                        cfg.learning_rate), mesh=mesh)
    reset_launch_counts()
    with scatter_held_to_plain() as calls, split_held_to_plain() as splits:
        losses = [float(step(batch)) for _ in range(SHARD_SPLIT_STEPS)]
    counts = launch_counts()
    differ = [int(c) for c in calls]
    split_differ = [int(c) for c in splits]
    want = {k: SHARD_SPLIT_STEPS
            if k in ("scatter_rows", "apply_split_rows") else 0
            for k in counts}
    if (counts != want or any(differ) or len(differ) != SHARD_SPLIT_STEPS
            or any(split_differ) or len(split_differ) != SHARD_SPLIT_STEPS):
        fail(f"rank {rank}: split layout launches {counts} (expected "
             f"{want}), elements differing from the plain scatter {differ}, "
             f"from the plain split update {split_differ}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"rank {rank}: split layout losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rlog(rank, f"[split D = {world}] bf16 + row-wise Adagrad shard "
         f"{tuple(model.embedding_layer.stack_state(0)['table'].shape)}; "
         f"losses {losses}; B3 launches {counts['scatter_rows']}, each "
         f"held to the plain scatter on a copy of the shard (elements "
         f"differing {differ}); split kernel launches "
         f"{counts['apply_split_rows']}, each held to its plain version "
         f"(elements differing {split_differ}); peak device memory "
         f"{peak:.2f} GB")
    del model, step, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "counts": counts, "peak_gb": peak}


def rank_autogrow(rank: int, world: int, seed: int) -> dict:
    """Phase 36: a skewed batch over capacity through
    preprocess_on_device(training=True) at D = 2 (both ranks grow the
    same way, the merged stats show no drop, the activations equal a
    layer built with the grown capacities bit for bit), and a layer of
    nested feature configs, whose activations come back in the nest and
    equal those of its from_config rebuild (a list)."""
    import torch

    from keras_rs_tpu_torch.layers.embedding.config import (
        FeatureConfig,
        TableConfig,
    )
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
        flatten,
    )
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    B, L, V = 4096, 8, 100_000

    def layer_of(C, U, **kw):
        t = TableConfig("hot", V, 128, optimizer="adagrad",
                        placement="sharded", max_ids_per_partition=C,
                        max_unique_ids_per_partition=U)
        return DistributedEmbedding(
            [FeatureConfig("f", t, (B, L), (B, 128))],
            generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, mesh=mesh, **kw)

    g = np.random.default_rng(seed)
    ids = g.integers(0, V, (B, L))
    # Half the ids on a few hot rows of shard 0: its buckets overflow.
    hot = g.random((B, L)) < 0.5
    ids = np.where(hot, 2 * g.integers(0, 8, (B, L)), ids)
    local = [torch.from_numpy(_rank_rows({"f": ids}, rank, world)["f"]).to(
        dev)]
    layer = layer_of(64, 64)
    pre = layer.preprocess_on_device(local, training=True)
    grown = (layer.stacks[0].max_ids_per_partition,
             layer.stacks[0].max_unique_ids_per_shard)
    merged = layer.update_stats(warn=False)[layer.stacks[0].name]
    if merged.dropped_ids or grown[0] <= 64:
        fail(f"rank {rank}: auto-grow: capacities {grown}, stats {merged}")
    # The forward depends on the bucket capacity only; U per shard is
    # a multiple of D here, so round the grown U up.
    twin = layer_of(grown[0], -(-grown[1] // world))
    pre2, stats = twin.preprocess_on_device(local, return_stats=True)
    name = layer.stacks[0].name
    same_coo = all(torch.equal(pre["sharded"][name][k],
                               pre2["sharded"][name][k])
                   for k in ("recv_slots", "recv_segs", "recv_gains"))
    # The sorted forward sums with index_add_, whose CUDA atomics add in
    # any order unless deterministic algorithms are on.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            got, want = layer(pre)[0], twin(pre2)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    if not (same_coo and torch.equal(got, want)) or any(
            int(s.dropped_ids) for s in stats.values()):
        fail(f"rank {rank}: the grown layer differs from one built with "
             f"its capacities (COO equal: {same_coo})")

    def nested_configs():
        ta = TableConfig("ta", 5000, 128, optimizer="adagrad",
                         placement="sharded")
        tb = TableConfig("tb", 3000, 64, optimizer="sgd", combiner="mean",
                         placement="sharded")
        return {"g": {"a": FeatureConfig("a", ta, (B, 4), (B, 128))},
                "h": [FeatureConfig("b", tb, (B, 2), (B, 64)),
                      FeatureConfig("c", tb, (B, 3), (B, 64))]}

    nested = DistributedEmbedding(
        nested_configs(), device=dev, mesh=mesh,
        generator=torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    x = {k: torch.from_numpy(_rank_rows(
        {k: rng.integers(0, v, (B, n))}, rank, world)[k]).to(dev)
        for k, v, n in (("a", 5000, 4), ("b", 3000, 2), ("c", 3000, 3))}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            out = nested({"g": {"a": x["a"]}, "h": [x["b"], x["c"]]})
            rebuilt = DistributedEmbedding.from_config(dict(
                nested.get_config(), device=dev, mesh=mesh,
                generator=torch.Generator(device=dev).manual_seed(seed)))
            flat = rebuilt([x["a"], x["b"], x["c"]])
    finally:
        torch.use_deterministic_algorithms(False)
    leaves, structure = flatten(out, lambda v: isinstance(v, torch.Tensor))
    if structure != nested._feature_structure or not all(
            torch.equal(a, b) for a, b in zip(leaves, flat)):
        fail(f"rank {rank}: nested configs: {structure}")
    rlog(rank, f"[autogrow D = {world}] capacities (C, U) (64, 128) -> "
         f"{grown}, merged stats {merged}; equal to a layer built with "
         f"them; nested configs {structure} round-trip through "
         "get_config / from_config")
    return {"grown": grown, "structure": str(structure)}


# --- phases 37-42: the sharded path's second half over two ranks ---------

#: Phase 40's vocabulary cap: a D = 1 copy of the model and a D = 1
#: freeze beside the D = 2 ones in each rank (full widths: 26 features,
#: dim 128).
SHARD_FREEZE_CAP = 1_000_000
#: Phase 41: candidates x dim (f32), queries, k.
SHARDED_RETRIEVAL = (10_000_000, 128, 256, 10)


def state_digest(tensors) -> tuple[int, int]:
    """(sum, position-weighted sum) of the bytes of `tensors`, in int64
    that wraps, in chunks on their device: equal states give equal
    digests, and a changed, moved or swapped byte changes them."""
    import torch

    total = weighted = 0
    pos = 0
    for t in tensors:
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        for lo in range(0, flat.numel(), 1 << 26):
            b = flat[lo : lo + (1 << 26)].long()
            idx = torch.arange(pos + lo, pos + lo + b.numel(),
                               device=b.device)
            total += int(b.sum())
            weighted = (weighted + int((b * idx).sum())) % (1 << 63)
        pos += flat.numel()
    return total, weighted


def model_digest(model, optimizer) -> tuple[int, int]:
    """state_digest of a model's parameters and buffers (the stacked
    tables, slots and step counters) and the dense optimizer's state."""
    return state_digest([*model.state_dict().values(),
                         *optimizer.accumulators])


def rank_pipelined_step0(rank: int, world: int, seed: int) -> dict:
    """Phase 37, first part: the ml_perf entry point's model at the 4M
    cap (packed, full widths, batch 16,384 as 2 x 8,192): one
    unpipelined data-parallel step, then a model built again from the
    same seed takes pipelined step 0 on the same batch (its prefetch
    the next batch). Deterministic algorithms on: the losses equal and
    the whole state (tables, slots, step counters, dense parameters, the
    dense optimizer) digests equal. Both steps' B1 calls are held to the
    plain version."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models.dlrm import bce_loss
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training import pipelined as pipelining
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    capped = [min(v, VOCAB_CAP) for v in CRITEO_VOCAB_SIZES]
    cfg = mlperf.CONFIGS["full_criteo"](vocab_sizes=capped,
                                        device_preprocessing=True)
    raws = list(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size, vocab_sizes=capped,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(2, seed=seed))

    def fresh():
        model = mlperf.build_model(cfg, dev, mesh)
        return model, DenseAdagrad(model.parameters(), cfg.learning_rate)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with b1_held_to_plain() as calls:
            model, opt = fresh()
            batches = [model.to_device(_rank_rows(r, rank, world))
                       for r in raws]
            step = make_train_step(model, mlperf.make_loss_fn(True), opt,
                                   mesh=mesh)
            plain = float(step(batches[0]))
            want = model_digest(model, opt)
            del model, opt, step
            torch.cuda.empty_cache()
            model, opt = fresh()
            embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
            state = pipelining.create_pipelined_train_state(
                model, opt, get_pre(batches[0]), embed_fn)
            pstep = pipelining.make_pipelined_train_step(
                bce_loss, opt, embed_fn, get_pre, inject, mesh=mesh)
            piped = float(pstep(state, batches[0], get_pre(batches[1]))[1])
            got = model_digest(model, opt)
            del model, opt, state, pstep, batches
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    held = [float(c["err"]) for c in calls]
    if (plain != piped or want != got or len(calls) != 2
            or any(bool(c["bad"]) for c in calls)):
        fail(f"rank {rank}: pipelined step 0 at D = {world}: loss {piped!r} "
             f"against the unpipelined {plain!r}, state digest {got} "
             f"against {want}; B1 held {held}")
    rlog(rank, f"[pipelined step 0 D = {world}] loss {piped!r} equals the "
         f"unpipelined step's; whole state digest {got} equal; both B1 "
         f"calls held to the plain version, max_abs_err {held}")
    return {"loss": piped}


def rank_pipelined_split(rank: int, world: int, seed: int) -> dict:
    """Phase 38: the split layout (bf16 tables, row-wise Adagrad, 4M
    cap) in the pipelined step at D = 2, device preprocessing: one batch
    SHARD_SPLIT_STEPS times (its own prefetch target), the global loss
    falls, every row scatter (B3 on the rank's shard) held to its plain
    version on a copy of the whole shard and every split kernel call to
    its plain version, B3 and the split kernel once per step."""
    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2, bce_loss
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training import pipelined as pipelining
    from keras_rs_tpu_torch.training.train_state import DenseAdagrad

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    cfg = slice_config(table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad")
    cfg.max_ids_per_partition //= world
    cfg.max_unique_ids_per_partition //= world
    torch.cuda.reset_peak_memory_stats()
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev, mesh=mesh)
    raw = next(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(1, seed=seed))
    batch = model.to_device(_rank_rows(raw, rank, world))
    opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
    embed_fn, get_pre, inject = mlperf.pipeline_fns(model, True)
    state = pipelining.create_pipelined_train_state(model, opt,
                                                    get_pre(batch), embed_fn)
    pstep = pipelining.make_pipelined_train_step(
        bce_loss, opt, embed_fn, get_pre, inject, mesh=mesh)
    reset_launch_counts()
    with scatter_held_to_plain() as calls, split_held_to_plain() as splits:
        losses = [float(pstep(state, batch, get_pre(batch))[1])
                  for _ in range(SHARD_SPLIT_STEPS)]
    counts = launch_counts()
    differ = [int(c) for c in calls]
    split_differ = [int(c) for c in splits]
    want = {k: SHARD_SPLIT_STEPS
            if k in ("scatter_rows", "apply_split_rows") else 0
            for k in counts}
    if (counts != want or any(differ) or len(differ) != SHARD_SPLIT_STEPS
            or any(split_differ) or len(split_differ) != SHARD_SPLIT_STEPS):
        fail(f"rank {rank}: pipelined split launches {counts} (expected "
             f"{want}), elements differing from the plain scatter {differ}, "
             f"from the plain split update {split_differ}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        fail(f"rank {rank}: pipelined split losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rlog(rank, f"[pipelined split D = {world}] losses {losses}; B3 "
         f"launches {counts['scatter_rows']}, each held to the plain "
         f"scatter on a copy of the shard (elements differing {differ}); "
         f"split kernel launches {counts['apply_split_rows']}, each held "
         f"to its plain version (elements differing {split_differ}); "
         f"peak device memory {peak:.2f} GB")
    del model, opt, state, pstep, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "counts": counts}


def rank_checkpoint(rank: int, world: int, seed: int, path: str) -> dict:
    """Phase 39: a sharded checkpoint of the entry point's model at full
    widths (packed, at the 4M cap where the disk under `path` holds
    both ranks' files with a quarter to spare, else at
    SHARD_FREEZE_CAP): one data-parallel step, save_checkpoint of the
    model and the dense optimizer (each rank its file), the next step;
    then a model holding other values restores it (the digest of its
    whole state equals the saved one) and takes the same next step
    (loss and digest equal). Deterministic algorithms on; every B1 call held.
    Reports GB, s and GB/s of each rank's save and restore."""
    import shutil

    import torch

    from keras_rs_tpu_torch.data.criteo import CriteoDataset
    from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training import checkpoint
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    full = mlperf.CONFIGS["full_criteo"]()
    large = [v for v in CRITEO_VOCAB_SIZES if v >= full.embedding_threshold]
    # Packed f32 Adagrad: 2 x 128 f32 per row, each rank 1 / D of them.
    need = sum(min(v, VOCAB_CAP) for v in large) * 1024 * 1.25
    free = shutil.disk_usage(path).free
    cap = VOCAB_CAP if free > need else SHARD_FREEZE_CAP
    capped = [min(v, cap) for v in CRITEO_VOCAB_SIZES]
    cfg = mlperf.CONFIGS["full_criteo"](vocab_sizes=capped,
                                        device_preprocessing=True)
    raws = list(CriteoDataset(
        None, global_batch_size=cfg.global_batch_size, vocab_sizes=capped,
        multi_hot_sizes=cfg.multi_hot_sizes).dummy_batches(2, seed=seed))
    target = os.path.join(path, "state")

    def fresh(other):
        model = mlperf.build_model(cfg, dev, mesh)
        opt = DenseAdagrad(model.parameters(), cfg.learning_rate)
        if other:  # other values everywhere, for the restore to replace
            with torch.no_grad():
                for t in [*model.parameters(), *model.buffers(),
                          *opt.accumulators]:
                    if t.is_floating_point():
                        t.add_(1.0)
        return model, opt, make_train_step(
            model, mlperf.make_loss_fn(True), opt, mesh=mesh)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with b1_held_to_plain() as calls:
            model, opt, step = fresh(False)
            batches = [model.to_device(_rank_rows(r, rank, world))
                       for r in raws]
            step(batches[0])
            saved = model_digest(model, opt)
            checkpoint.save_checkpoint(target, {"model": model,
                                                "optimizer": opt})
            loss_a = float(step(batches[1]))
            after_a = model_digest(model, opt)
            del model, opt, step
            torch.cuda.empty_cache()
            model, opt, step = fresh(True)
            checkpoint.restore_checkpoint(target, {"model": model,
                                                   "optimizer": opt})
            restored = model_digest(model, opt)
            loss_b = float(step(batches[1]))
            after_b = model_digest(model, opt)
            del model, opt, step, batches
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    nbytes = os.path.getsize(os.path.join(
        target, f"rank{rank}-of-{world}.pt"))
    files = sorted(os.listdir(target))
    if (restored != saved or loss_a != loss_b or after_a != after_b
            or any(bool(c["bad"]) for c in calls) or len(calls) != 3):
        fail(f"rank {rank}: sharded checkpoint: digest {restored} against "
             f"{saved}, next loss {loss_b!r} against {loss_a!r}, after "
             f"{after_b} against {after_a}; B1 calls {len(calls)}")
    gb = nbytes / 1e9
    rlog(rank, f"[checkpoint D = {world}] cap {cap:,} rows ({free / 1e9:.1f}"
         f" GB free under the directory, {need / 1e9:.1f} GB needed for "
         f"4M); files {files}; this rank's file {gb:.3f} GB; restored "
         f"digest equal; the next step's loss {loss_b!r} and state equal")
    return {"cap": cap, "gb": gb}


def rank_freeze(rank: int, world: int, seed: int) -> dict:
    """Phase 40: freeze() and serving_copy() at D = 2 of the entry
    point's model at full widths, vocabularies capped at
    SHARD_FREEZE_CAP: the D = 2 freeze (f32 and int8) equals, tensor for
    tensor and on a serving batch, the freeze of a D = 1 model built in
    this rank from the same seed (the same logical tables); the serving
    copy answers a batch as the training layer does, holds no slot and
    copies its own shard. Reports the freeze's bytes."""
    import torch

    from keras_rs_tpu_torch.models.dlrm import DLRMDCNv2
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    one_cfg = slice_config(vocab_cap=SHARD_FREEZE_CAP)
    cfg = slice_config(vocab_cap=SHARD_FREEZE_CAP)
    cfg.max_ids_per_partition //= world
    cfg.max_unique_ids_per_partition //= world

    def build(c, m):
        return DLRMDCNv2(
            c, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev, mesh=m)

    model = build(cfg, mesh)
    one = build(one_cfg, mesh_lib.Mesh((mesh_lib.DATA_AXIS,), (1,), dev))
    layer, layer1 = model.embedding_layer, one.embedding_layer
    raw = dlrm_batch(cfg, seed)
    ids = {f"cat_{i}": torch.from_numpy(raw[f"cat_{i}"]).to(dev)
           for i in model.large_idx}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.no_grad():
            for q in (None, "int8"):
                frozen = layer.freeze(quantize=q)
                want = layer1.freeze(quantize=q)
                a, b = frozen.state_dict(), want.state_dict()
                same = sorted(a) == sorted(b) and all(
                    torch.equal(a[k], b[k]) for k in a)
                ga, gb = frozen(ids), want(ids)
                same_acts = all(torch.equal(ga[k], gb[k]) for k in gb)
                if not (same and same_acts):
                    fail(f"rank {rank}: freeze({q!r}) at D = {world} differs "
                         f"from D = 1 (tensors {same}, activations "
                         f"{same_acts})")
                out[str(q)] = module_bytes(frozen)
                del frozen, want, a, b, ga, gb
                torch.cuda.empty_cache()
            del one, layer1
            torch.cuda.empty_cache()
            local = _rank_rows(ids, rank, world)
            copy = layer.serving_copy()
            got = copy(copy.preprocess_on_device(local))
            want = layer(layer.preprocess_on_device(local))
            buffers = dict(copy.named_buffers())
    finally:
        torch.use_deterministic_algorithms(False)
    slots = [k for k in buffers if "slot" in k]
    shared = {t.data_ptr() for t in layer.buffers()} & {
        t.data_ptr() for t in buffers.values()}
    if (not all(torch.equal(got[k], want[k]) for k in want) or slots
            or shared or copy.num_shards != world):
        fail(f"rank {rank}: serving_copy at D = {world}: slots {slots}, "
             f"shared storage {len(shared)}")
    copy_bytes, train_bytes = module_bytes(copy), module_bytes(layer)
    rlog(rank, f"[freeze D = {world}] cap {SHARD_FREEZE_CAP:,}: f32 freeze "
         f"{out['None']} B, int8 {out['int8']} B, each equal "
         f"to the D = 1 freeze (tensors and a batch of "
         f"{len(raw['label'])}); serving_copy {copy_bytes} B of this "
         f"rank's shard (training layer {train_bytes} B), no slot, no "
         "shared storage, its forward equal to the training layer's")
    del model, layer, copy
    torch.cuda.empty_cache()
    return {"freeze": out, "copy_bytes": copy_bytes}


def rank_retrieval(rank: int, world: int, seed: int) -> None:
    """Phase 41: ShardedBruteForceRetrieval over SHARDED_RETRIEVAL's
    candidates (f32 gaussians drawn on the card from `seed`, every rank
    the same, each keeping its half) against the port's one-device
    BruteForceRetrieval in this rank: the ids equal, the scores within
    1e-5 relative."""
    import torch

    from keras_rs_tpu_torch.layers.retrieval.retrieval import (
        BruteForceRetrieval,
    )
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.parallel.sharded_retrieval import (
        ShardedBruteForceRetrieval,
    )

    dev = torch.device("cuda", 0)
    mesh = mesh_lib.create_mesh(dev)
    n, dim, b, k = SHARDED_RETRIEVAL
    g = torch.Generator(device=dev).manual_seed(seed)
    cands = torch.randn((n, dim), generator=g, device=dev)
    queries = torch.randn((b, dim), generator=g, device=dev)
    sharded = ShardedBruteForceRetrieval(cands, k=k, mesh=mesh)
    one = BruteForceRetrieval(cands, k=k)
    with torch.no_grad():
        s, top = sharded(queries)
        s1, top1 = one(queries)
    if not (torch.equal(top, top1)
            and torch.allclose(s, s1, rtol=1e-5, atol=0)):
        fail(f"rank {rank}: sharded retrieval differs from one device: "
             f"{int((top != top1).sum())} ids")
    rlog(rank, f"[sharded retrieval D = {world}] {n:,} x {dim} f32, {b} "
         f"queries, k = {k}: ids equal to the one-device "
         "BruteForceRetrieval")
    del cands, sharded, one
    torch.cuda.empty_cache()


def rank_examples(rank: int, world: int) -> dict:
    """Phase 42: examples/data_parallel_retrieval.py and
    examples/ann_retrieval.py at D = 2, and dryrun_multichip(2)."""
    import torch

    from keras_rs_tpu_torch.examples import ann_retrieval
    from keras_rs_tpu_torch.examples import data_parallel_retrieval
    from keras_rs_tpu_torch.parallel.dryrun import dryrun_multichip

    dev = torch.device("cuda", 0)
    dp = data_parallel_retrieval.main(device=dev)
    if not (all(map(math.isfinite, dp["loss"]))
            and dp["loss"][-1] < dp["loss"][0] and dp["recall"] > 0):
        fail(f"rank {rank}: data_parallel_retrieval {dp}")
    ann = ann_retrieval.main(device=dev)
    exact = ann["brute force"]["ids"]
    name = f"sharded exact x{world}"
    if not (ann[name]["recall"] == 1.0
            and np.array_equal(ann[name]["ids"], exact)):
        fail(f"rank {rank}: ann_retrieval's sharded engine: "
             f"recall {ann[name]['recall']}")
    dry = dryrun_multichip(world, dev)
    rlog(rank, f"[examples D = {world}] data_parallel_retrieval losses "
         f"{dp['loss'][0]:.4f} -> {dp['loss'][-1]:.4f}, recall@10 "
         f"{dp['recall']:.3f}; ann_retrieval recall "
         f"{ {k: v['recall'] for k, v in ann.items()} }; "
         f"dryrun_multichip({world}) {dry}")
    return {"dp_loss": dp["loss"][-1], "dry": dry}


def run_sharded(seed: int) -> dict[str, int]:
    """Phases 33-42 on SHARD_RANKS spawned ranks; returns the launches
    of B1 (the entry point runs of phases 34 and 37) and B3 (phases 35
    and 38), summed over the ranks."""
    import torch

    torch.cuda.empty_cache()
    ranks = Ranks(SHARD_RANKS)
    try:
        probe = ranks.run("rank_probe")
        for key in probe[0]:
            log(f"[probe] gloo on CUDA tensors, {key}: "
                f"{[p[key] for p in probe]}")
        broken = sorted({key for p in probe
                         for key, v in p.items() if v != "ok"})
        if broken:
            fail(f"gloo does not carry {broken} on CUDA tensors: "
                 f"{probe}")
        cmp = ranks.run("rank_compare", seed=seed)
        ml = ranks.run("rank_mlperf", seed=seed)
        split = ranks.run("rank_split", seed=seed)
        grow = ranks.run("rank_autogrow", seed=seed)
        step0 = ranks.run("rank_pipelined_step0", seed=seed)
        piped = ranks.run("rank_mlperf", seed=seed, pipeline_embedding=True)
        piped_split = ranks.run("rank_pipelined_split", seed=seed)
        ck_dir = tempfile.mkdtemp(prefix="sharded_ckpt_")
        try:
            ck = ranks.run("rank_checkpoint", seed=seed, path=ck_dir)
        finally:
            shutil.rmtree(ck_dir, ignore_errors=True)
        frz = ranks.run("rank_freeze", seed=seed)
        ranks.run("rank_retrieval", seed=seed)
        ex = ranks.run("rank_examples")
    finally:
        ranks.close()
    losses = [r["results"]["loss"] for r in ml]
    if len(set(losses)) != 1 or len({c["losses"]["d2"][-1]
                                     for c in cmp}) != 1:
        fail(f"ranks disagree on the global loss: {losses}")
    if len({g["grown"] for g in grow}) != 1:
        fail(f"ranks grew differently: {[g['grown'] for g in grow]}")
    if len({tuple(s["losses"]) for s in split}) != 1:
        fail(f"ranks disagree on the split layout's losses")
    for label, runs in (("pipelined step 0", [[r["loss"]] for r in step0]),
                        ("pipelined mlperf",
                         [[r["results"]["loss"]] for r in piped]),
                        ("pipelined split", [r["losses"] for r in piped_split]),
                        ("data_parallel_retrieval",
                         [[r["dp_loss"]] for r in ex])):
        if len({tuple(r) for r in runs}) != 1:
            fail(f"ranks disagree on the {label} losses: {runs}")
    for label in ("f32", "bf16"):
        log(f"[sharded] collective bytes per rank of one full-width "
            f"training step at D = {SHARD_RANKS}, {label} exchange "
            f"(parallel/collectives.count_bytes): "
            f"{[c['bytes'][label] for c in cmp]}")
    log(f"[sharded] D = {SHARD_RANKS} on one card, gloo: peak GB "
        f"{[r['peak_gb'] for r in ml]}; pipelined peak GB "
        f"{[r['peak_gb'] for r in piped]}; checkpoint per rank GB "
        f"{[c['gb'] for c in ck]} at cap {ck[0]['cap']:,}; freeze bytes "
        f"{[f['freeze'] for f in frz]} at cap {SHARD_FREEZE_CAP:,}")
    return {
        "apply_scatter_row_blocks": sum(
            r["counts"]["apply_scatter_row_blocks"] for r in ml + piped),
        "scatter_rows": sum(s["counts"]["scatter_rows"]
                            for s in split + piped_split),
        "apply_split_rows": sum(s["counts"]["apply_split_rows"]
                                for s in split + piped_split),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights and the batches")
    args = parser.parse_args()

    if not (ROOT / "keras_rs_tpu_torch" / "csrc").is_dir():
        fail(f"keras_rs_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    from keras_rs_tpu_torch.utils.timing import card_line

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this runs on a GPU only")

    # The ml_perf entry point logs its progress and results line.
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(name)s] %(message)s", force=True)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.cuda.set_device(torch.device("cuda", 0))
    t0 = time.perf_counter()
    phase_build()

    b1, slots_4m, sink_4m = run_dlrm(args.seed)
    log(f"[time] packed DLRM phases done at {time.perf_counter() - t0:.1f} s")
    kernels = [b1] + run_row_scatter(args.seed, slots_4m, sink_4m)
    log(f"[time] capacity and row-scatter phases done at "
        f"{time.perf_counter() - t0:.1f} s")
    kernels += run_sasrec(args.seed)
    log(f"[time] SASRec phases done at {time.perf_counter() - t0:.1f} s")
    phase_coo(args.seed)
    run_mlperf(args.seed)
    phase_auc()
    run_mlperf_files(args.seed)
    log(f"[time] COO, ml_perf, AUC and file phases done at "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    reset_launch_counts()
    phase_retrieval_small(dev, args.seed)
    run_retrieval(dev, args.seed)
    run_ranking(dev, args.seed)
    if any(launch_counts().values()):
        fail(f"retrieval and ranking launched kernels: {launch_counts()}")
    log(f"[time] retrieval and ranking phases done at "
        f"{time.perf_counter() - t0:.1f} s ({card}; no kernel launched)")
    phase_serving_small(args.seed)
    phase_export(args.seed)
    log(f"[time] serving phases done at {time.perf_counter() - t0:.1f} s")
    run_a13(dev, args.seed)
    log(f"[time] GRU4Rec, layer and checkpoint phases done at "
        f"{time.perf_counter() - t0:.1f} s")
    run_pipelined(dev, args.seed)
    run_pipelined_split(dev, args.seed)
    run_walkthroughs(dev)
    log(f"[time] pipelined and walkthrough phases done at "
        f"{time.perf_counter() - t0:.1f} s")
    run_bench(dev)
    log(f"[time] bench phase done at {time.perf_counter() - t0:.1f} s")
    sharded = run_sharded(args.seed)
    for k in kernels:
        if k["name"] in sharded:
            log(f"[launches] {k['name']}: {k['launches']} on one device, "
                f"{sharded[k['name']]} on the {SHARD_RANKS} ranks")
            k["launches"] += sharded[k["name"]]
    log(f"[time] sharded phases done at {time.perf_counter() - t0:.1f} s")

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
