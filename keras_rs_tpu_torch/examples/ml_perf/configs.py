"""MLPerf DLRM-DCNv2 experiment configs.

The port's copy of examples/ml_perf/configs.py, with the same names and
values: the full 26-feature Criteo vocabulary (4x40M, 3M, 590k, ...),
embedding_dim 128, Adagrad lr 0.0034, global batch 16384, max_ids 8192 /
max_unique 4096, embedding_threshold 21000 (the reference's
configs/v6e_8.py:15-190, 202-205). One field selects a path the port's
main.py does not have yet; main.py raises for it rather than ignore it
(the multi-device exchange dtype).
"""

from __future__ import annotations

import dataclasses

# Criteo 26 categorical vocab sizes (reference configs/v6e_8.py:15-172).
CRITEO_VOCAB_SIZES = [
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
    40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14,
    40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
]
CRITEO_MULTI_HOT_SIZES = [
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
    27, 10, 3, 1, 1,
]


@dataclasses.dataclass
class ExperimentConfig:
    name: str
    vocab_sizes: list
    multi_hot_sizes: list
    embedding_dim: int = 128
    bottom_mlp: tuple = (512, 256, 128)
    top_mlp: tuple = (1024, 1024, 512, 256, 1)
    num_dcn_layers: int = 3
    dcn_projection_dim: int = 512
    embedding_threshold: int = 21_000
    max_ids_per_partition: int = 8192
    max_unique_ids_per_partition: int = 4096
    learning_rate: float = 0.0034
    global_batch_size: int = 16_384
    num_steps: int = 28_000
    file_pattern: str | None = None  # None -> dummy data
    val_file_pattern: str | None = None  # None -> dummy eval batches
    #: The reference's full-dataset TFRecords pack this many logical
    #: records per tf.train.Example (FILE-BATCHED schema — label
    #: Int64List[N], per-key dense FloatLists, categorical BytesLists
    #: of raw-i64 strings; reference configs/v6e_8_full_dataset.py:17
    #: sets 4224). None = one record per Example.
    file_batch_size: int | None = None
    num_loader_threads: int = 4
    #: Run the COO preprocessing on the device inside the training step
    #: instead of on host loader threads (layers/embedding/
    #: device_preprocessing.py); the loader threads then only hand over
    #: the raw ids. Capacities are set to the worst case automatically,
    #: since the device path's shapes are static.
    device_preprocessing: bool = False
    #: Safety factor over the uniform-MOD-sharding expectation when
    #: auto-sizing the device path's per-shard UNIQUE capacity (the
    #: id-bucket capacity is always worst-case). The absolute worst case
    #: (every id of every shard congruent mod D) would need
    #: factor=num_shards; that inflates the backward's per-unique-row
    #: work D-fold, so the default covers 4x skew and training logs the
    #: observed dropped_ids so residual truncation is visible.
    device_unique_factor: int = 4
    #: One-step-stale pipelined embedding execution (the reference TF
    #: backend's `pipeline_execution_with_tensor_core`): the lookup for
    #: batch t+1 runs on a side CUDA stream beside batch t's dense
    #: compute (training/pipelined.py), at the cost of lookups being one
    #: update old. A resumed pipelined run re-primes the prefetch from
    #: its first batch.
    pipeline_embedding: bool = False
    do_profile: bool = False
    #: After training, measure the train step's device time over chained
    #: steps with CUDA events (utils/timing.py) and report
    #: `device_step_ms` / `device_examples_per_sec`: the device numbers,
    #: independent of the host loader.
    honest_timing: bool = False
    #: Evaluate (streaming AUC/accuracy over the eval batches) every N
    #: training steps and record an `auc_curve` in the results — the
    #: convergence-to-plateau evidence (reference target protocol:
    #: configs/v6e_32_full_dataset.py:205, AUC 0.8275). 0 = final only.
    eval_every: int = 0
    #: Where `do_profile` writes its trace. None: `keras_rs_tpu_profile`
    #: under the process's temporary directory (TMPDIR).
    profile_dir: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1000
    #: "bfloat16" halves the bytes of the multi-device embedding
    #: exchange: the lookup's reduce-scatter and all-gather run in bf16
    #: (DistributedEmbedding's comm_dtype; one process sends nothing).
    embedding_comm_dtype: str | None = None
    #: "bfloat16" keeps dense-stack activations resident in bf16
    #: between matmuls (parameters and accumulation stay f32), the JAX
    #: package's default. Pass "float32" for f32-resident numerics.
    dense_output_dtype: str | None = "bfloat16"


def full_criteo(name="full_criteo", **overrides) -> ExperimentConfig:
    """The full Criteo shapes; `overrides` may also replace vocab_sizes
    or multi_hot_sizes (the JAX package's full_criteo rejects those), so
    that main("full_criteo", vocab_sizes=...) runs a capped vocabulary."""
    fields = dict(
        vocab_sizes=list(CRITEO_VOCAB_SIZES),
        multi_hot_sizes=list(CRITEO_MULTI_HOT_SIZES),
    )
    fields.update(overrides)
    return ExperimentConfig(name=name, **fields)


def smoke_test(**overrides) -> ExperimentConfig:
    """Tiny config for CI / single-chip smoke runs."""
    defaults = dict(
        vocab_sizes=[100_000, 50_000, 1000, 500, 60_000, 30],
        multi_hot_sizes=[3, 2, 1, 1, 4, 1],
        embedding_dim=32,
        bottom_mlp=(64, 32),
        top_mlp=(128, 64, 1),
        dcn_projection_dim=32,
        max_ids_per_partition=1024,
        max_unique_ids_per_partition=1024,
        global_batch_size=512,
        num_steps=20,
    )
    defaults.update(overrides)
    return ExperimentConfig(name="smoke_test", **defaults)


# Per-topology configs mirroring the reference's five experiment files
# (configs/v6e_8.py, v6e_16.py, v6e_{8,16,32}_full_dataset.py). They
# share the model shape and differ only in data source, global batch,
# and step budget (reference v6e_8.py:195-198, v6e_16.py:197-200,
# v6e_16_full_dataset.py:202-205, v6e_32_full_dataset.py:202-205).
# The topology is not part of a config, so these are named for the
# reference runs they reproduce.


def v6e_8(**overrides) -> ExperimentConfig:
    """Dummy-data bring-up run (reference v6e_8.py: batch 128, 2 steps)."""
    defaults = dict(global_batch_size=128, num_steps=2)
    defaults.update(overrides)
    return full_criteo(name="v6e_8", **defaults)


def v6e_16(**overrides) -> ExperimentConfig:
    """Dummy-data 2-host run (reference v6e_16.py: batch 16896, 10 steps)."""
    defaults = dict(global_batch_size=16_896, num_steps=10)
    defaults.update(overrides)
    return full_criteo(name="v6e_16", **defaults)


def _full_dataset(name, num_steps, **overrides) -> ExperimentConfig:
    defaults = dict(
        file_pattern="criteo/train/*.tfrecord",
        val_file_pattern=None,
        global_batch_size=16_384,
        num_steps=num_steps,
    )
    defaults.update(overrides)
    return full_criteo(name=name, **defaults)


def v6e_8_full_dataset(**overrides) -> ExperimentConfig:
    return _full_dataset("v6e_8_full_dataset", num_steps=2, **overrides)


def v6e_16_full_dataset(**overrides) -> ExperimentConfig:
    return _full_dataset("v6e_16_full_dataset", num_steps=40, **overrides)


def v6e_32_full_dataset(**overrides) -> ExperimentConfig:
    """The MLPerf target run: 28000 steps at global batch 16384."""
    return _full_dataset(
        "v6e_32_full_dataset", num_steps=28_000, **overrides
    )


CONFIGS = {
    "full_criteo": full_criteo,
    "smoke_test": smoke_test,
    "v6e_8": v6e_8,
    "v6e_16": v6e_16,
    "v6e_8_full_dataset": v6e_8_full_dataset,
    "v6e_16_full_dataset": v6e_16_full_dataset,
    "v6e_32_full_dataset": v6e_32_full_dataset,
}
