"""MLPerf DLRM-DCNv2 training entry point, on one CUDA device or one
process per device.

The port of examples/ml_perf/main.py: the DLRM-DCNv2 of configs.py
trained on Criteo TFRecord files or on learnable dummy batches, with the
COO preprocessing either on host loader threads (`ThreadedDataLoader`,
`num_loader_threads`; the C++ engine where it builds, numpy otherwise)
or on the device inside the training step (`--device_preprocessing`).
Dense parameters take Adagrad in optax's formula; the stacked tables
take their embedding optimizer inside the lookup's backward, in place.
After training it evaluates streaming AUC and accuracy and logs the same
`results: {...}` line as the JAX entry point.

On one device the large tables always go to the stacked engine
(`table_placement="sharded"`; the JAX package's "auto" keeps them as
dense tables on a one-device mesh and runs no COO path at all). Host
mode builds the model with the config's capacities (8192 / 4096 in the
MLPerf configs) and its loader threads preprocess with
`preprocess_host(batch, training=True)`, as main.py:85-86,146-147 do:
the embedding layer grows a stack's capacities when a batch overflows
them and preprocesses that batch again, so no id is dropped (growth
holds the layer's lock; a batch built before another thread's growth
keeps its own shapes). The capacities then depend on which batch
overflowed first, so with more than one loader thread they may differ
from run to run, never falling. Device mode, and every rank at D > 1,
takes the worst-case capacities main.py:87-108 gives the device mode
(`capacities`): the device transform has static shapes and does not
grow, and drops the ids over a capacity without a warning. So device
mode trains with the spans and counters of utils/tracing.py on, and
every 100 steps logs a warning if the "embedding.dropped_ids" counter,
which sums every step's drops on the device, rose since the last one.
At the end, `main` logs each stack's capacities and the ids the host
mode dropped.

Under torchrun (WORLD_SIZE > 1) every process is one rank of a 1-D mesh
(parallel/): it holds its shard of the large tables, a replica of the
dense model and its B / D samples of every batch (CriteoDataset's
process slicing), preprocesses on the device (forced, as the JAX entry
point forces it with more than one process: the host COO needs the
global batch), and averages the dense gradients over the ranks. The
capacities are sized for D as main.py:87-108 sizes them. The eval's
streaming AUC and accuracy sum their state over the ranks; the exact
rank AUC cross-check runs with one process only (main.py:425-440). Rank
r runs on cuda:LOCAL_RANK unless `--device` names another device, and
the process group's backend is NCCL on CUDA unless `--dist_backend`
names another: two ranks on one card need `--device cuda:0
--dist_backend gloo`. `--pipeline_embedding` and `checkpoint_dir` work
at D > 1 too: the pipelined step is data parallel like the plain one
(training/pipelined.py), and each rank saves its shards beside rank 0's
dense state in one directory per step (training/checkpoint.py).

With `checkpoint_dir`, every `checkpoint_every` steps the model (its
stacked tables, slots and step counters included) and the dense
optimizer are saved (training/checkpoint.py), and a rerun resumes from
the latest complete step, logging "resumed from checkpoint step N" (on
every rank) as the JAX entry point does. `--profile` (or
KRT_PROFILE_DIR) traces steps 10-20 with torch.profiler into
`profile_dir` (`--profile_dir`; by default `keras_rs_tpu_profile` under
TMPDIR), with tracing on from step 10: the trace holds the step's spans
(utils/tracing.py) as `user_annotation` ranges.
`--pipeline_embedding` trains with one-step-stale lookups
(training/pipelined.py): the lookup of the next batch, and in device
mode its COO transform, runs on a side CUDA stream beside the dense
compute, with one batch of lookahead.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.ml_perf.main --config smoke_test \
      --device cpu
  python -m keras_rs_tpu_torch.examples.ml_perf.main --config smoke_test \
      --device_preprocessing          # on cuda:0
  torchrun --nproc_per_node 2 -m keras_rs_tpu_torch.examples.ml_perf.main \
      --config smoke_test --device cuda:0 --dist_backend gloo
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch.data.criteo import CriteoDataset
from keras_rs_tpu_torch.data.loader import ThreadedDataLoader
from keras_rs_tpu_torch.examples.ml_perf.configs import (
    CONFIGS,
    ExperimentConfig,
)
from keras_rs_tpu_torch.metrics.classification import AUC, BinaryAccuracy
from keras_rs_tpu_torch.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
from keras_rs_tpu_torch.parallel import collectives, multihost
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.training import pipelined as pipelining
from keras_rs_tpu_torch.training.checkpoint import CheckpointManager
from keras_rs_tpu_torch.training.trainer import (
    start_profiler,
    stop_profiler,
)
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils import tracing
from keras_rs_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("ml_perf")


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (equivalent to the Wilcoxon statistic)."""
    order = np.argsort(scores)
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def capacities(cfg: ExperimentConfig, D: int = 1) -> tuple[int, int]:
    """(max_ids_per_partition, max_unique_ids_per_partition) over D
    shards: the worst case of main.py:87-108, every large id of a shard's
    B / D samples in one bucket, and device_unique_factor times the mean
    per-shard count of uniques (at D = 1 every id unique)."""
    large_mh = sum(
        m for v, m in zip(cfg.vocab_sizes, cfg.multi_hot_sizes)
        if v >= cfg.embedding_threshold
    )
    max_ids = (cfg.global_batch_size // D) * large_mh
    max_unique = max(
        1, min(max_ids, cfg.device_unique_factor * -(-max_ids // D))
    )
    return max_ids, max_unique


def model_config(cfg: ExperimentConfig, D: int = 1,
                 grow: bool = False) -> DLRMConfig:
    """The config's DLRMConfig over D shards: with `grow` (host mode)
    the config's capacities, which training grows; else `capacities(cfg,
    D)`, the worst case."""
    max_ids, max_unique = (
        (cfg.max_ids_per_partition, cfg.max_unique_ids_per_partition)
        if grow else capacities(cfg, D))
    return DLRMConfig(
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        embedding_dim=cfg.embedding_dim,
        bottom_mlp=cfg.bottom_mlp,
        top_mlp=cfg.top_mlp,
        num_dcn_layers=cfg.num_dcn_layers,
        dcn_projection_dim=cfg.dcn_projection_dim,
        embedding_threshold=cfg.embedding_threshold,
        max_ids_per_partition=max_ids,
        max_unique_ids_per_partition=max_unique,
        learning_rate=cfg.learning_rate,
        global_batch_size=cfg.global_batch_size,
        table_placement="sharded",
        dense_output_dtype=cfg.dense_output_dtype,
        embedding_comm_dtype=cfg.embedding_comm_dtype,
    )


def build_model(cfg: ExperimentConfig, device: torch.device,
                mesh: mesh_lib.Mesh | None = None,
                grow: bool = False) -> DLRMDCNv2:
    """The config's model with its weights drawn from seed 0 (on every
    rank: the dense replicas start equal, and the logical tables are
    those of one device); `grow` as in `model_config`."""
    D = 1 if mesh is None else mesh.size
    return DLRMDCNv2(
        model_config(cfg, D, grow),
        generator=torch.Generator(device=device).manual_seed(0),
        device=device,
        mesh=mesh,
    )


def make_loss_fn(device_preprocessing: bool):
    """The training loss of a batch as the loader hands it over: a raw
    batch on the device (COO transform inside the step) or a
    preprocessed one."""
    if device_preprocessing:
        def loss_fn(m: DLRMDCNv2, b: dict) -> torch.Tensor:
            return bce_loss(m, m.preprocess_on_device(b))

        return loss_fn
    return bce_loss


def pipeline_fns(model: DLRMDCNv2, device_preprocessing: bool):
    """(embed_fn, get_pre, inject) of the pipelined step
    (training/pipelined.py): in device mode the large features' raw ids
    are the embedding input and the COO transform runs inside the
    prefetch (JAX main.py:170-200); small-table ids and dense floats are
    consumed raw by the model."""
    if not device_preprocessing:
        return pipelining.dlrm_pipeline_fns()
    _, _, inject = pipelining.dlrm_pipeline_fns()

    def embed_fn(m: DLRMDCNv2, raw_large: dict):
        layer = m.embedding_layer
        return layer, layer.preprocess_on_device(raw_large)

    def get_pre(batch: dict) -> dict:
        return {f"cat_{i}": batch[f"cat_{i}"] for i in model.large_idx}

    return embed_fn, get_pre, inject


def _raw(batch: dict) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_dir(cfg: ExperimentConfig) -> str:
    """`cfg.profile_dir`, else `keras_rs_tpu_profile` under TMPDIR."""
    return cfg.profile_dir or os.path.join(tempfile.gettempdir(),
                                           "keras_rs_tpu_profile")


def merge_metric(metric: Any, group) -> None:
    """A streaming metric's state summed over the ranks of `group`, in
    place (its counts and sums add)."""
    state = metric._state
    metric._state = type(state)(*(collectives.all_reduce(t.clone(), group)
                                  for t in state))


def stack_capacities(model: DLRMDCNv2, grow: bool) -> dict[str, dict]:
    """Each stack's capacities and, in host mode (`grow`), the ids its
    training passes dropped (this process's folded stats; None in device
    mode, which does not count them), logged and returned by stack
    name."""
    if model.embedding_layer is None:
        return {}
    stats = model.embedding_layer.input_stats
    out = {}
    for stack in model.embedding_layer.stacks:
        st = stats.get(stack.name)
        out[stack.name] = {
            "max_ids_per_partition": stack.max_ids_per_partition,
            "max_unique_ids_per_shard": stack.max_unique_ids_per_shard,
            "dropped_ids": (None if not grow
                            else 0 if st is None else st.dropped_ids),
        }
        logger.info("stack %s: %s", stack.name, out[stack.name])
    return out


def main(config_name: str = "smoke_test", *, device: Any = None,
         dist_backend: str | None = None, **overrides) -> dict:
    """Trains and evaluates the named config (with `overrides` of its
    fields); returns the results dict it logs. `device` defaults to
    cuda:0, or cuda:LOCAL_RANK with more than one process (then the
    process group starts here with `dist_backend`, by default NCCL on
    CUDA; parallel/multihost.py)."""
    cfg = CONFIGS[config_name](**overrides)
    device = multihost.rank_device(device)
    started_group = not dist.is_initialized() and multihost.initialize(
        device, dist_backend)
    mesh = mesh_lib.create_mesh(device)
    D = mesh.size
    group = mesh.group(mesh.axis_names)
    rank = multihost.process_index()
    if D > 1 and not cfg.device_preprocessing:
        # The host COO needs the global batch; a rank holds its samples.
        logger.info("%d processes: enabling device_preprocessing", D)
        cfg.device_preprocessing = True
    logger.info("config=%s device=%s processes=%d rank=%d "
                "device_preprocessing=%s", cfg.name, device, D, rank,
                cfg.device_preprocessing)
    # Host mode grows the config's capacities (D = 1 only: D > 1 forced
    # device mode above).
    grow = not cfg.device_preprocessing
    model = build_model(cfg, device, mesh, grow)
    logger.info("capacities: max_ids_per_partition=%d "
                "max_unique_ids_per_partition=%d%s",
                model.config.max_ids_per_partition,
                model.config.max_unique_ids_per_partition,
                " (grown in training)" if grow else "")

    dataset = CriteoDataset(
        cfg.file_pattern,
        global_batch_size=cfg.global_batch_size,
        vocab_sizes=cfg.vocab_sizes,
        multi_hot_sizes=cfg.multi_hot_sizes,
        process_index=rank,
        process_count=D,
        file_batch_size=cfg.file_batch_size,
    )

    def raw_batches():
        if cfg.file_pattern:
            yield from dataset.batches(epochs=1000)
        else:
            yield from dataset.dummy_batches(cfg.num_steps)

    # Workers return host arrays (the raw batch, or its host COO); the
    # consuming thread moves them to the device.
    def preprocess_host(batch: dict) -> dict:
        return model.preprocess_host(batch, training=True)

    loader = ThreadedDataLoader(
        raw_batches(),
        _raw if cfg.device_preprocessing else preprocess_host,
        transfer_fn=model.to_device,
        num_workers=cfg.num_loader_threads,
    )
    optimizer = DenseAdagrad(model.parameters(), cfg.learning_rate)
    pipelined = (cfg.pipeline_embedding
                 and model.embedding_layer is not None)
    next_batch = None
    if pipelined:
        embed_fn, get_pre, inject = pipeline_fns(model,
                                                 cfg.device_preprocessing)
        next_batch = next(loader)
        state = pipelining.create_pipelined_train_state(
            model, optimizer, get_pre(next_batch), embed_fn)
        pipelined_step = pipelining.make_pipelined_train_step(
            bce_loss, optimizer, embed_fn, get_pre, inject, mesh=mesh)

        def step_fn(batch: dict, next_pre: Any) -> torch.Tensor:
            return pipelined_step(state, batch, next_pre)[1]
    else:
        step_fn = make_train_step(
            model, make_loss_fn(cfg.device_preprocessing), optimizer,
            mesh=mesh)
        state = {"model": model, "optimizer": optimizer}
    ckpt = (CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir
            else None)
    # Checkpoint-restart: a rerun with the same checkpoint_dir resumes
    # from its latest step instead of starting over.
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        ckpt.restore(start_step, state)
        logger.info("resumed from checkpoint step %d", start_step)
        if pipelined and start_step < cfg.num_steps:
            # The checkpoint holds no prefetch: prime it from the
            # resumed loop's first batch (step-0 semantics).
            state.prefetched = pipelining.prime(
                model, get_pre(next_batch), embed_fn)

    auc_m = AUC(num_thresholds=512, device=device)
    acc_m = BinaryAccuracy(device=device)

    def eval_batch_iter():
        if cfg.val_file_pattern:
            return CriteoDataset(
                cfg.val_file_pattern,
                global_batch_size=cfg.global_batch_size,
                vocab_sizes=cfg.vocab_sizes,
                multi_hot_sizes=cfg.multi_hot_sizes,
                process_index=rank,
                process_count=D,
                file_batch_size=cfg.file_batch_size,
            ).batches(epochs=1)
        return dataset.dummy_batches(4, seed=777)

    @torch.no_grad()
    def run_eval(collect_probs: bool = False):
        """(accuracy, auc, labels, probs) over the eval set."""
        auc_m.reset_state()
        acc_m.reset_state()
        ck_labels, ck_probs = [], []
        for eval_batch in eval_batch_iter():
            if cfg.device_preprocessing:
                b = model.preprocess_on_device(model.to_device(eval_batch))
            else:
                b = model.preprocess(eval_batch)
            probs = torch.sigmoid(model(b).float())
            auc_m.update_state(b["label"], probs)
            acc_m.update_state(b["label"], probs)
            if collect_probs:
                ck_labels.append(np.asarray(eval_batch["label"]))
                ck_probs.append(probs.cpu().numpy())
        if D > 1:
            merge_metric(auc_m, group)
            merge_metric(acc_m, group)
        return (float(acc_m.result()), float(auc_m.result()), ck_labels,
                ck_probs)

    t0 = time.time()
    warmup = min(10, max(0, cfg.num_steps - start_step - 1))
    t_warm = t0
    losses, auc_curve = [], []
    batch = None
    profiler = None
    trace_dir = (profile_dir(cfg) if D == 1
                 else os.path.join(profile_dir(cfg), f"rank{rank}"))
    # Device mode counts its dropped ids, and a profile holds the spans:
    # tracing (utils/tracing.py) on, then back as the caller had it.
    tracing_was_on = tracing.enabled()
    if cfg.device_preprocessing:
        tracing.enable()
    # This rank's drops before the loop (the device COO's counter).
    dropped_seen = tracing.counters().get("embedding.dropped_ids", 0)
    try:
        for step in range(start_step, cfg.num_steps):
            if cfg.do_profile and step == 10:
                profiler = start_profiler(device)
                tracing.enable()
            if pipelined:
                # One batch of lookahead: the step prefetches the next
                # batch's activations; the last step feeds its own batch
                # again (the prefetch is discarded).
                batch = next_batch
                if step + 1 < cfg.num_steps:
                    next_batch = next(loader)
                loss = step_fn(batch, get_pre(next_batch))
            else:
                batch = next(loader)
                loss = step_fn(batch)
            losses.append(loss)
            if step - start_step + 1 == warmup:
                # Throughput counts from here (first-call costs excluded).
                _sync(device)
                t_warm = time.time()
            if profiler is not None and step == 20:
                stop_profiler(profiler, trace_dir, device)
                profiler = None
            if ckpt is not None and (step + 1) % cfg.checkpoint_every == 0:
                ckpt.save(step + 1, state)
            if cfg.eval_every and (step + 1) % cfg.eval_every == 0:
                # Eval wall time stays out of the training throughput.
                t_eval = time.time()
                acc_pt, auc_pt, _, _ = run_eval()
                auc_curve.append(
                    {"step": step + 1, "auc": auc_pt, "accuracy": acc_pt}
                )
                logger.info("eval @ step %d: auc %.4f acc %.4f", step + 1,
                            auc_pt, acc_pt)
                t_warm += time.time() - t_eval
            if (step + 1) % 100 == 0:
                logger.info(
                    "step %d loss %.5f (%.1f ex/s post-warmup)", step + 1,
                    float(loss),
                    cfg.global_batch_size * (step - start_step + 1 - warmup)
                    / max(time.time() - t_warm, 1e-9),
                )
                if cfg.device_preprocessing:
                    dropped = tracing.counters().get(
                        "embedding.dropped_ids", 0)
                    if dropped > dropped_seen:
                        logger.warning(
                            "device preprocessing dropped %d ids by step %d "
                            "(unique capacity overflow: raise "
                            "device_unique_factor)", dropped - dropped_seen,
                            step + 1,
                        )
                    dropped_seen = dropped
        if profiler is not None:  # fewer than 21 steps: trace what ran
            stop_profiler(profiler, trace_dir, device)
    finally:
        if not tracing_was_on:
            tracing.disable()
    _sync(device)
    throughput = (
        cfg.global_batch_size * max(cfg.num_steps - start_step - warmup, 0)
        / max(time.time() - t_warm, 1e-9)
    )
    if ckpt is not None:
        ckpt.close()
    capacities_used = stack_capacities(model, grow)

    device_step_ms = None
    if cfg.honest_timing and batch is not None:
        from keras_rs_tpu_torch.utils.timing import measure_step_time

        timed_step = step_fn
        if pipelined:
            # Chained on the measured batch, its own embedding input as
            # the prefetch target: the work of a real lookahead step.
            def timed_step(b: dict) -> torch.Tensor:
                return step_fn(b, get_pre(b))

        device_step_ms = measure_step_time(timed_step, batch) * 1e3
        logger.info("device step: %.3f ms (%.1f ex/s on the device)",
                    device_step_ms,
                    cfg.global_batch_size / device_step_ms * 1e3)
    loader.stop()

    # Final eval; with one process the exact rank AUC on the host checks
    # the thresholded streaming one (it needs every probability).
    acc, auc, ck_labels, ck_probs = run_eval(collect_probs=D == 1)
    if D == 1:
        exact = binary_auc(np.concatenate(ck_labels),
                           np.concatenate(ck_probs))
        if abs(exact - auc) > 0.01:
            logger.warning("streaming AUC %.4f deviates from exact rank "
                           "AUC %.4f", auc, exact)

    results = {
        "loss": float(losses[-1]) if losses else float("nan"),
        "throughput": throughput,
        "accuracy": acc,
        "auc": auc,
        "capacities": capacities_used,
    }
    if auc_curve:
        results["auc_curve"] = auc_curve
    if device_step_ms is not None:
        results["device_step_ms"] = device_step_ms
        results["device_examples_per_sec"] = (
            cfg.global_batch_size / (device_step_ms / 1e3)
        )
    logger.info("results: %s", results)
    if started_group:
        dist.destroy_process_group()
    return results


def parse_args(argv: list[str] | None = None) -> tuple[str, dict]:
    """(config name, main's keyword arguments) from the command line
    (examples/ml_perf/main.py's flags, and --device)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="smoke_test")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0, or "
                        "cuda:LOCAL_RANK under torchrun)")
    parser.add_argument("--dist_backend", default=None,
                        help="torch.distributed backend with more than one "
                        "process (default nccl on CUDA, gloo on the CPU)")
    parser.add_argument("--num_steps", type=int, default=None)
    parser.add_argument("--global_batch_size", type=int, default=None)
    parser.add_argument(
        "--dense_output_dtype", default=None,
        help="e.g. bfloat16: bf16-resident dense activations "
        "(params/accumulation stay f32)",
    )
    parser.add_argument("--file_pattern", default=None)
    parser.add_argument("--val_file_pattern", default=None)
    parser.add_argument("--profile", action="store_true",
                        help="trace steps 10-20 with torch.profiler into "
                        "profile_dir (KRT_PROFILE_DIR sets both)")
    parser.add_argument("--profile_dir", default=None,
                        help="directory of the --profile trace (default "
                        "keras_rs_tpu_profile under TMPDIR)")
    parser.add_argument(
        "--device_preprocessing", action="store_true",
        help="run COO preprocessing on the device inside the step",
    )
    parser.add_argument(
        "--eval_every", type=int, default=None,
        help="evaluate every N steps and record an AUC curve",
    )
    parser.add_argument(
        "--pipeline_embedding", action="store_true",
        help="one-step-stale lookups: the next batch's lookup runs on a "
        "side CUDA stream beside the dense compute",
    )
    parser.add_argument(
        "--honest_timing", action="store_true",
        help="after training, measure the device step time with CUDA "
        "events over chained steps",
    )
    args = parser.parse_args(argv)
    overrides: dict[str, Any] = {}
    for name in ("num_steps", "global_batch_size", "dense_output_dtype",
                 "file_pattern", "val_file_pattern", "eval_every",
                 "profile_dir"):
        if getattr(args, name):
            overrides[name] = getattr(args, name)
    for flag, name in (("profile", "do_profile"),
                       ("device_preprocessing", "device_preprocessing"),
                       ("honest_timing", "honest_timing"),
                       ("pipeline_embedding", "pipeline_embedding")):
        if getattr(args, flag):
            overrides[name] = True
    # The JAX entry point's environment overrides.
    if os.environ.get("KRT_PROFILE_DIR"):
        overrides["do_profile"] = True
        overrides["profile_dir"] = os.environ["KRT_PROFILE_DIR"]
    if os.environ.get("KRT_CHECKPOINT_DIR"):
        overrides["checkpoint_dir"] = os.environ["KRT_CHECKPOINT_DIR"]
    for name in ("device", "dist_backend"):
        if getattr(args, name) is not None:
            overrides[name] = getattr(args, name)
    return args.config, overrides


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    name, kwargs = parse_args()
    main(name, **kwargs)
