"""Benchmark: DLRM-DCNv2 end-to-end training throughput on one CUDA device.

The port of the repository's `bench.py`. Both pipelines start from a raw
id batch already on the device:

  ours : the device COO transform inside the step
         (layers/embedding/device_preprocessing.py), the stacked lookup
         and its fused in-place optimizer (kernel B1 on the packed f32 +
         Adagrad state; B3 in the bf16 + row-wise Adagrad mix): updates
         cost O(unique rows);
  naive: dense EmbedReduce lookups, dense autograd gradients of whole
         tables and DenseAdagrad over them (`table_placement=
         "default_device"`). It needs no COO transform, so the two are
         compared end to end.

Then the roofline split: the same model with its embedding layer
stripped and the activations of one lookup fed as batch data (the
dense-only step), its MFU against the H100's bf16 peak, and the rest of
the step against the embedding path's byte floor (`embedding_floor_ms`).
Optional variants: the pipelined step (BENCH_PIPELINE=1;
training/pipelined.py) and the flagship valence (BENCH_FLAGSHIP, on by
default): the 26-table Criteo multi-hot mix of
examples/ml_perf/configs.py with every vocabulary capped at
BENCH_VOCAB_CAP rows.

Timing: utils/timing.measure_step_time, CUDA events around BENCH_BLOCKS
blocks of BENCH_ITERS chained steps after one warm-up block, the median
per step. The host enqueues each step eagerly, so where it is slower
than the device the figure is the host's, and the host's speed drifts
between blocks: ours and the dense-only step, whose difference is
`embedding_ms`, take their blocks in turn (measure_step_times), so both
meet the same host. The device's busy share of ours is printed beside
it, the kernel time per step of one block under
torch.profiler over the unprofiled step_ms (the profiled block's own
wall time, which the profiler's host work stretches, is printed too).
Each model is freed before the next is built.

Environment: BENCH_BATCH (8192), BENCH_VOCAB (4,000,000), BENCH_DIM
(128), BENCH_ITERS (20), BENCH_BLOCKS (5), BENCH_DENSE_REPEATS (1),
BENCH_SKIP_NAIVE (0), BENCH_PIPELINE (0), BENCH_FLAGSHIP (1),
BENCH_VOCAB_CAP (1,000,000), BENCH_FLAGSHIP_BATCH (BENCH_BATCH),
BENCH_FLAGSHIP_UNIQUE_HEADROOM (1.07; inf sizes the unique capacity for
no dedup), and the model's BENCH_TABLE_DTYPE (float32),
BENCH_EMB_OPTIMIZER (adagrad), BENCH_DENSE_OUTPUT_DTYPE (bfloat16) and
BENCH_COMM_DTYPE (none; no effect on one device).

Prints progress lines, the card's name and power limit (nvidia-smi),
the busy share, then last one JSON line with bench.py's keys:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "step_ms": ..., "dense_ms": ..., "embedding_floor_ms": ...,
   "mfu_dense": ..., "embedding_ms": ..., "embedding_floor_frac": ...}
plus the pipelined_* and flagship_* keys of the variants that ran (or
pipelined_error / flagship_error). Run from the repository root:

  python3 -m keras_rs_tpu_torch.bench
"""

from __future__ import annotations

import gc
import json
import os
import time
import traceback
from typing import Any

import numpy as np
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.examples.ml_perf.configs import (
    CRITEO_MULTI_HOT_SIZES,
    CRITEO_VOCAB_SIZES,
)
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
from keras_rs_tpu_torch.training import pipelined as pipelining
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils.device import resolve_device
from keras_rs_tpu_torch.utils.timing import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    card_line,
    device_ms,
    measure_step_time,
    measure_step_times,
)

#: Vocabularies at or above this size go to the stacked engine.
THRESHOLD = 21_000
#: The flagship valence's defaults: every Criteo vocabulary capped at
#: this many rows, and the unique capacity sized to the batch's counted
#: uniques times this headroom.
VOCAB_CAP = 1_000_000
FLAGSHIP_UNIQUE_HEADROOM = 1.07


def model_config(
    placement: str,
    batch_size: int,
    vocab: int,
    dim: int,
    vocab_sizes=None,
    multi_hot_sizes=None,
    max_unique=None,
) -> DLRMConfig:
    """bench.py's DLRMConfig on one device: the worst-case capacities
    (every large id of the batch in one bucket and unique, so nothing is
    dropped) unless `max_unique` sizes the unique capacity."""
    if vocab_sizes is None:
        vocab_sizes = [vocab, vocab // 2, 2000, 500]
        multi_hot_sizes = [3, 2, 1, 1]
    large_ids = sum(
        m for v, m in zip(vocab_sizes, multi_hot_sizes) if v >= THRESHOLD
    )
    return DLRMConfig(
        vocab_sizes=vocab_sizes,
        multi_hot_sizes=multi_hot_sizes,
        num_dense_features=13,
        embedding_dim=dim,
        bottom_mlp=(512, 256, dim),
        top_mlp=(1024, 512, 256, 1),
        num_dcn_layers=3,
        dcn_projection_dim=256,
        embedding_threshold=THRESHOLD,
        max_ids_per_partition=batch_size * large_ids,
        max_unique_ids_per_partition=(
            max_unique if max_unique is not None
            else batch_size * large_ids),
        learning_rate=0.0034,
        global_batch_size=batch_size,
        table_placement=placement,
        table_dtype=os.environ.get("BENCH_TABLE_DTYPE", "float32"),
        embedding_optimizer=os.environ.get("BENCH_EMB_OPTIMIZER",
                                           "adagrad"),
        dense_output_dtype=os.environ.get("BENCH_DENSE_OUTPUT_DTYPE",
                                          "bfloat16"),
        embedding_comm_dtype=os.environ.get("BENCH_COMM_DTYPE") or None,
    )


def build(
    placement: str,
    batch_size: int,
    vocab: int,
    dim: int,
    vocab_sizes=None,
    multi_hot_sizes=None,
    max_unique=None,
    device: Any = None,
    seed: int = 0,
):
    """(state, step, batch, cfg, model): the model of `model_config` with
    weights from `seed`, `synthetic.criteo_like_batch(seed=0)` moved to
    the device once, and `step(batch) -> loss`, the train step of
    `bce_loss(m, m.preprocess_on_device(b))` with DenseAdagrad. `state`
    holds the model and the dense optimizer. "sharded" is ours,
    "default_device" the naive baseline (on one device "auto" would
    resolve to default_device, so name the placement)."""
    device = resolve_device(device)
    cfg = model_config(placement, batch_size, vocab, dim, vocab_sizes,
                       multi_hot_sizes, max_unique)
    model = DLRMDCNv2(
        cfg, generator=torch.Generator(device=device).manual_seed(seed),
        device=device)
    raw = synthetic.criteo_like_batch(
        batch_size, vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes, seed=0)
    batch = model.to_device(raw)
    optimizer = DenseAdagrad(model.parameters(), cfg.learning_rate)

    def loss_fn(m: DLRMDCNv2, b: dict) -> torch.Tensor:
        return bce_loss(m, m.preprocess_on_device(b))

    step = make_train_step(model, loss_fn, optimizer)
    return {"model": model, "optimizer": optimizer}, step, batch, cfg, model


def dense_only(model: DLRMDCNv2, batch: dict, cfg: DLRMConfig):
    """(state, step, batch) of the dense-only measurement, from a built
    model and its raw device batch: the activations of one lookup
    (no_grad) become batch data ("large_acts"), the embedding layer is
    stripped from the model (its state is freed and no optimizer covers
    it: a lookup that never runs must not stay under the state), and
    DenseAdagrad covers the dense parameters only. The model is changed
    in place."""
    with torch.no_grad():
        acts = model.embedding_layer(
            model.preprocess_on_device(batch)["large_pre"])
    model.embedding_layer = None
    batch = dict(batch, large_acts=acts)
    optimizer = DenseAdagrad(model.parameters(), cfg.learning_rate)
    step = make_train_step(model, bce_loss, optimizer)
    return {"model": model, "optimizer": optimizer}, step, batch


def build_pipelined(batch_size: int, vocab: int, dim: int,
                    device: Any = None):
    """(step, batch) of the pipelined variant (one-step-stale lookups,
    training/pipelined.py) of ours: `step(raw)` runs one device COO
    transform per batch, which feeds both this batch's update and,
    standing in for the next batch, the prefetch on the side stream."""
    state, _, raw, _, model = build("sharded", batch_size, vocab, dim,
                                    device=device)
    embed_fn, get_pre, inject = pipelining.dlrm_pipeline_fns()
    body = pipelining.make_pipelined_train_step(
        bce_loss, state["optimizer"], embed_fn, get_pre, inject)
    with torch.no_grad():
        first_pre = model.preprocess_on_device(raw)["large_pre"]
    state_p = pipelining.create_pipelined_train_state(
        model, state["optimizer"], first_pre, embed_fn)
    del first_pre

    def step(raw: dict) -> torch.Tensor:
        b = model.preprocess_on_device(raw)
        return body(state_p, b, b["large_pre"])[1]

    return step, raw


def flagship_shape(batch_size: int, cap: int = VOCAB_CAP,
                   headroom: float = FLAGSHIP_UNIQUE_HEADROOM):
    """(vocab_sizes, multi_hot_sizes, unique_rows, max_unique) of the
    flagship valence: the Criteo multi-hot mix (~172 large-table ids per
    example) with every vocabulary capped at `cap` so the stacked state
    fits (~7.0M rows at the default cap). `unique_rows` counts the
    distinct ids of each large table in the batch `build` makes, and the
    unique capacity is that count times `headroom`, rounded up to 8, as
    the reference's configs size it below the id count (inf: None, the
    capacity of no dedup)."""
    vocab_sizes = [min(v, cap) for v in CRITEO_VOCAB_SIZES]
    multi_hot_sizes = list(CRITEO_MULTI_HOT_SIZES)
    raw = synthetic.criteo_like_batch(
        batch_size, vocab_sizes=vocab_sizes,
        multi_hot_sizes=multi_hot_sizes, seed=0)
    unique_rows = sum(len(np.unique(raw[f"cat_{i}"]))
                      for i, v in enumerate(vocab_sizes) if v >= THRESHOLD)
    max_unique = (None if headroom == float("inf")
                  else int(-(-unique_rows * headroom // 8) * 8))
    return vocab_sizes, multi_hot_sizes, unique_rows, max_unique


def dense_flops_per_step(cfg, batch_size: int) -> float:
    """Analytic forward + backward matmul FLOPs of the dense stack (MLPs
    and DCN): the backward of a matmul is twice its forward, so 3x the
    forward. Elementwise work is not counted."""
    concat = cfg.bottom_mlp[-1] + cfg.embedding_dim * len(cfg.vocab_sizes)
    macs = 0
    prev = cfg.num_dense_features
    for u in cfg.bottom_mlp:
        macs += prev * u
        prev = u
    for _ in range(cfg.num_dcn_layers):
        macs += concat * cfg.dcn_projection_dim * 2  # down + up proj
    prev = concat
    for u in cfg.top_mlp:
        macs += prev * u
        prev = u
    return 3.0 * 2.0 * macs * batch_size


def embedding_floor_ms(cfg, batch_size: int,
                       unique_rows: int | None = None) -> float:
    """The least time the H100 needs for the stacked embedding path of a
    step: the bytes it must move, over HBM_BYTES_PER_S, for the table
    dtype and embedding optimizer of `cfg`. An entry is one id of a large
    table, `unique_rows` the batch's distinct rows (None: every entry
    distinct, right for the near-collision-free main shape; the flagship
    passes its count, since the update stops at n_valid). With dim d, a
    table row of t = d x the table dtype's bytes, and optimizer slots of
    s bytes per row (4d for each [R, d] f32 slot, 4 for each row-wise
    [R] f32 slot):

      * forward: each entry's table row read, t bytes;
      * backward: each entry's f32 cotangent row read, 4d bytes;
      * update: each unique row's table row and slots read and written
        (2(t + s) bytes), its f32 gradient row read (4d) and its index
        read (4).

    The packed f32 + Adagrad state (kernel B1) has t = s = 4d: its
    [2, d] block read and written, 16d bytes per unique row, as
    chip_smoke.py bounds B1. The bf16 + row-wise Adagrad mix (B3) has
    t = 2d and s = 4.
    """
    entries = sum(
        m
        for v, m in zip(cfg.vocab_sizes, cfg.multi_hot_sizes)
        if v >= cfg.embedding_threshold
    ) * batch_size
    unique = entries if unique_rows is None else unique_rows
    d = cfg.embedding_dim
    table_row = d * getattr(torch, cfg.table_dtype).itemsize
    opt = opt_lib.get(cfg.embedding_optimizer)
    slots = sum(4 if name in opt.rowwise_slots else 4 * d
                for name in opt.slot_names)
    forward = entries * table_row
    cotangent = entries * 4 * d
    update = unique * (2 * (table_row + slots) + 4 * d + 4)
    return (forward + cotangent + update) / HBM_BYTES_PER_S * 1e3


def roofline_fields(step_s: float, dense_s: float, flops: float,
                    floor_ms: float) -> dict:
    """bench.py's derived roofline fields from the full step's and the
    dense-only step's seconds. A dense-only step no faster than the full
    step, or an MFU above 1, means the sub-measurement went wrong: the
    derived fields are then null and `dense_error` says why."""
    mfu = flops / dense_s / PEAK_FLOPS["bfloat16"]
    if dense_s >= step_s or mfu > 1.0:
        return {
            "mfu_dense": None,
            "embedding_ms": None,
            "embedding_floor_frac": None,
            "dense_error": (
                f"dense-only sub-measurement implausible (dense_ms="
                f"{dense_s * 1e3:.3f} vs step_ms={step_s * 1e3:.3f}, raw "
                f"mfu={mfu:.3f}); derived roofline fields withheld"),
        }
    emb_ms = (step_s - dense_s) * 1e3
    return {
        "mfu_dense": round(mfu, 3),
        "embedding_ms": round(emb_ms, 3),
        "embedding_floor_frac": round(min(floor_ms / emb_ms, 1.0), 3),
    }


def kernel_ms(step, batch, iters: int) -> tuple[float, float]:
    """(kernel ms, profiled wall ms) per step of one block of `iters`
    chained `step(batch)` calls under torch.profiler: the device time of
    its kernel and copy rows, and the block's wall time between two
    synchronizes. The profiler's own host work stretches a host-paced
    block, so the device's busy share of a step is the kernel time over
    the unprofiled step time, not over this wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return device_ms(prof.key_averages()) / iters, wall_ms / iters


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _log(msg: str) -> None:
    print(f"[bench] {msg}", flush=True)


def _error(e: Exception) -> str:
    traceback.print_exc()
    return f"{type(e).__name__}: {e}"[:200]


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "keras_rs_tpu_torch.bench needs a CUDA device: a CPU time is "
            "not a bench result.")
    device = torch.device("cuda", 0)
    batch_size = int(os.environ.get("BENCH_BATCH", 8192))
    vocab = int(os.environ.get("BENCH_VOCAB", 4_000_000))
    dim = int(os.environ.get("BENCH_DIM", 128))
    iters = int(os.environ.get("BENCH_ITERS", 20))
    blocks = int(os.environ.get("BENCH_BLOCKS", 5))

    def timed(step, batch, n_blocks: int = blocks) -> float:
        return measure_step_time(step, batch, iters, n_blocks)

    _, step, batch, cfg, _ = build("sharded", batch_size, vocab, dim,
                                   device=device)

    def measure_with_dense_only() -> tuple[float, float]:
        """(ours, dense-only) seconds per step, their blocks in turn."""
        _, _, raw_d, cfg_d, model = build("sharded", batch_size, vocab,
                                          dim, device=device)
        _, step_d, batch_d = dense_only(model, raw_d, cfg_d)
        del raw_d
        _release()  # the stripped state
        return tuple(measure_step_times(
            [(step, batch), (step_d, batch_d)], iters, blocks))

    dense_repeats = int(os.environ.get("BENCH_DENSE_REPEATS", 1))
    ours_samples, dense_samples = [], []
    for _ in range(dense_repeats):
        ours_r, dense_r = measure_with_dense_only()
        ours_samples.append(ours_r)
        dense_samples.append(dense_r)
        _release()
    step_s = float(np.median(ours_samples))
    dense_s = float(np.median(dense_samples))
    busy_ms, profiled_ms = kernel_ms(step, batch, iters)
    del step, batch
    _release()
    _log(f"ours: {step_s * 1e3!r} ms per step")
    _log(f"dense-only: {[s * 1e3 for s in dense_samples]} ms per step")

    naive = None
    if os.environ.get("BENCH_SKIP_NAIVE", "0") != "1":
        _, step, batch, _, _ = build("default_device", batch_size, vocab,
                                     dim, device=device)
        naive_s = timed(step, batch)
        del step, batch
        _release()
        naive = batch_size / naive_s
        _log(f"naive: {naive_s * 1e3!r} ms per step")

    ours = batch_size / step_s
    floor_ms = embedding_floor_ms(cfg, batch_size)
    out = {
        "metric": "dlrm_dcnv2_train_examples_per_sec",
        "value": round(ours, 1),
        "unit": "examples/s",
        "vs_baseline": round(ours / naive, 3) if naive else None,
        "step_ms": round(step_s * 1e3, 3),
        "dense_ms": round(dense_s * 1e3, 3),
        "embedding_floor_ms": round(floor_ms, 3),
    }
    if dense_repeats > 1:
        out.update(
            dense_ms_samples=[round(s * 1e3, 3) for s in dense_samples],
            dense_ms_mean=round(float(np.mean(dense_samples)) * 1e3, 3),
            dense_ms_std=round(float(np.std(dense_samples)) * 1e3, 3),
        )
    out.update(roofline_fields(step_s, dense_s,
                               dense_flops_per_step(cfg, batch_size),
                               floor_ms))

    if os.environ.get("BENCH_PIPELINE", "0") == "1":
        try:
            step_p, raw = build_pipelined(batch_size, vocab, dim,
                                          device=device)
            p_s = timed(step_p, raw)
            del step_p, raw
            out.update(
                pipelined_examples_per_sec=round(batch_size / p_s, 1),
                pipelined_step_ms=round(p_s * 1e3, 3),
            )
            _log(f"pipelined: {p_s * 1e3!r} ms per step")
        except Exception as e:  # noqa: BLE001 — the main line survives
            out.update(pipelined_error=_error(e))
        _release()

    # The flagship valence (~172 large-table ids per example, 5 above).
    if os.environ.get("BENCH_FLAGSHIP", "1") == "1":
        try:
            fb = int(os.environ.get("BENCH_FLAGSHIP_BATCH", batch_size))
            fv, fm, uniq, max_u = flagship_shape(
                fb, int(os.environ.get("BENCH_VOCAB_CAP", VOCAB_CAP)),
                float(os.environ.get("BENCH_FLAGSHIP_UNIQUE_HEADROOM",
                                     FLAGSHIP_UNIQUE_HEADROOM)))
            _, step_f, batch_f, cfg_f, _ = build(
                "sharded", fb, vocab, dim, vocab_sizes=fv,
                multi_hot_sizes=fm, max_unique=max_u, device=device)
            f_s = timed(step_f, batch_f, max(3, blocks - 2))
            del step_f, batch_f
            large_ids = sum(m for v, m in zip(fv, fm)
                            if v >= cfg_f.embedding_threshold)
            out.update(
                flagship_examples_per_sec=round(fb / f_s, 1),
                flagship_step_ms=round(f_s * 1e3, 3),
                flagship_entries_per_batch=large_ids * fb,
                flagship_unique_rows=uniq,
                flagship_embedding_floor_ms=round(
                    embedding_floor_ms(cfg_f, fb, unique_rows=uniq), 3),
            )
            _log(f"flagship: {f_s * 1e3!r} ms per step, {uniq} unique "
                 f"rows of {large_ids * fb} entries")
        except Exception as e:  # noqa: BLE001 — the main line survives
            out.update(flagship_error=_error(e))
        _release()

    _log(card_line())
    _log(f"device busy {busy_ms / (step_s * 1e3):.1%} of ours' "
         f"{step_s * 1e3!r} ms step: {busy_ms!r} ms of kernels and copies "
         f"per step in one block under torch.profiler (whose host work "
         f"stretched that block to {profiled_ms!r} ms per step)")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
