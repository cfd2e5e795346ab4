"""keras_rs_tpu_torch: the PyTorch + CUDA port of keras_rs_tpu.

The JAX package `keras_rs_tpu` stays the reference; this package mirrors
its module paths and names, imports `torch` and numpy only, and carries
hand-written CUDA kernels (under `csrc/`, built with nvcc at first use by
`kernels/`) where the JAX package has Pallas kernels.

Slices ported so far: the one-device DLRM-DCNv2 training step and its
scoring forward (models/dlrm.py), with the fused Adagrad row-update kernel
(ops/row_ops.py, csrc/row_ops.cu); SASRec trained and served
(models/sasrec.py, training/trainer.py, layers/retrieval), with the fused
attention forward, dQ and dK/dV kernels (ops/flash_attention.py,
csrc/flash_attention.cu); two-tower retrieval and listwise ranking
(models/two_tower.py, models/ranking_model.py, layers/retrieval, losses,
metrics/ranking_metrics.py), which reach no kernel; serving
(serving.py: CUDA-graph capture and torch.export artifacts of frozen
f32 or int8 tables, DistributedEmbedding.freeze / serving_copy), with
Ragged and sparse inputs (data/ragged.py, data/sparse_utils.py), which
reaches no kernel either; GRU4Rec (models/gru4rec.py, layers/recurrent.py)
trained through the full Trainer (training/trainer.py: prefetch,
validation, checkpoints of training/checkpoint.py, metrics log,
profiling, evaluate), the full-rank FeatureCross, DotInteraction,
regularizers (core/regularizers.py), the registry of core/serialization.py
and learning-rate schedules for the embedding optimizers, which reach no
kernel beyond B1 (a schedule's rate is read from the device); pipelined
embedding (training/pipelined.py: the next batch's lookup on a side CUDA
stream, one update old, B1 or B3 in every step), has_aux loss functions
and the walkthrough examples (examples/); the sharded embedding over D > 1
ranks of torch.distributed (parallel/: meshes, collectives, multi-process
helpers; DistributedEmbedding's mesh, the per-rank device COO with its
all_to_all, the lookup's reduce-scatter and all-gather around B1 / B3 on
each rank's shard), capacity growth and nested feature configs, and the
ml_perf entry point under torchrun. Modules build on cuda:0 unless given
`device=` (utils/device.py).
"""

from keras_rs_tpu_torch.version import __version__, version

__all__ = ["__version__", "version"]
