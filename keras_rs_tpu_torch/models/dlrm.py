"""DLRM-DCNv2 (counterpart of keras_rs_tpu/models/dlrm.py).

Bottom MLP over dense features -> concat with large-vocabulary (stacked
DistributedEmbedding) and small-vocabulary (EmbedReduce) embedding
activations -> DCNv2 low-rank FeatureCross layers -> top MLP -> logit.
Features with vocabulary >= embedding_threshold are "large". A batch may
carry their activations precomputed under "large_acts" (keyed "cat_i"),
which bypasses the embedding layer: a FrozenEmbedding of the large
features (DistributedEmbedding.freeze) then feeds the dense stack.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.layers.dense import MLP, _dtype
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
    FeatureCross,
)
from keras_rs_tpu_torch.utils.device import resolve_device, to_device


class DLRMConfig:
    """Criteo-shaped configuration, with the JAX package's defaults
    (the MLPerf widths; bf16 compute and bf16-resident activations).

    `table_dtype` and `embedding_optimizer` apply to the large, stacked
    tables only. The default, f32 tables with Adagrad, gives the packed
    [R, 2, dim] state whose update is kernel B1. `table_dtype="bfloat16"`
    with `embedding_optimizer="rowwise_adagrad"` is capacity mode: a bf16
    [R, dim] table with stochastically rounded updates and one f32
    accumulator per row, 260 bytes per row at dim 128 instead of 1,024,
    updated by the row scatter (kernel B3). Any optimizer of
    layers/embedding/optimizers.py may be named. `embedding_comm_dtype`
    ("bfloat16") sends the sharded lookup's two exchanges in bf16 when
    the model is sharded over more than one rank."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        multi_hot_sizes: Sequence[int] | None = None,
        num_dense_features: int = 13,
        embedding_dim: int = 128,
        bottom_mlp: Sequence[int] = (512, 256, 128),
        top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1),
        num_dcn_layers: int = 3,
        dcn_projection_dim: int = 512,
        embedding_threshold: int = 21000,
        max_ids_per_partition: int = 8192,
        max_unique_ids_per_partition: int = 4096,
        learning_rate: float = 0.0034,
        global_batch_size: int = 256,
        table_placement: str = "auto",
        table_dtype: str = "float32",
        compute_dtype: str | None = "bfloat16",
        embedding_optimizer: str = "adagrad",
        dense_output_dtype: str | None = "bfloat16",
        embedding_comm_dtype: str | None = None,
    ):
        self.vocab_sizes = list(vocab_sizes)
        self.multi_hot_sizes = list(
            multi_hot_sizes
            if multi_hot_sizes is not None
            else [1] * len(vocab_sizes)
        )
        self.num_dense_features = num_dense_features
        self.embedding_dim = embedding_dim
        self.bottom_mlp = list(bottom_mlp)
        self.top_mlp = list(top_mlp)
        self.num_dcn_layers = num_dcn_layers
        self.dcn_projection_dim = dcn_projection_dim
        self.embedding_threshold = embedding_threshold
        self.max_ids_per_partition = max_ids_per_partition
        self.max_unique_ids_per_partition = max_unique_ids_per_partition
        self.learning_rate = learning_rate
        self.global_batch_size = global_batch_size
        self.table_placement = table_placement
        self.table_dtype = table_dtype
        self.compute_dtype = compute_dtype
        self.embedding_optimizer = embedding_optimizer
        #: None/"float32" keeps f32 activations; "bfloat16" keeps the
        #: DCN/top-MLP stream in bf16 (parameters and bias adds stay f32).
        self.dense_output_dtype = (
            None if dense_output_dtype == "float32"
            else dense_output_dtype
        )
        self.embedding_comm_dtype = embedding_comm_dtype


def large_feature_configs(cfg: DLRMConfig) -> dict[str, FeatureConfig]:
    """The feature configs of the large (stacked) features, "cat_i" for
    each vocabulary >= cfg.embedding_threshold, as DLRMDCNv2 builds its
    DistributedEmbedding from them."""
    out = {}
    for i, vocab in enumerate(cfg.vocab_sizes):
        if vocab < cfg.embedding_threshold:
            continue
        table = TableConfig(
            name=f"table_{i}",
            vocabulary_size=vocab,
            embedding_dim=cfg.embedding_dim,
            optimizer=opt_lib.deserialize({
                "class_name": cfg.embedding_optimizer,
                "config": {"learning_rate": cfg.learning_rate},
            }),
            combiner="sum",
            placement=cfg.table_placement,
            dtype=cfg.table_dtype,
            max_ids_per_partition=cfg.max_ids_per_partition,
            max_unique_ids_per_partition=cfg.max_unique_ids_per_partition,
        )
        out[f"cat_{i}"] = FeatureConfig(
            name=f"cat_{i}",
            table=table,
            input_shape=(cfg.global_batch_size, cfg.multi_hot_sizes[i]),
            output_shape=(cfg.global_batch_size, cfg.embedding_dim),
        )
    return out


class DLRMDCNv2(nn.Module):
    """The model on one device, or one rank's part of it over a `mesh`
    (parallel/mesh.py) of D > 1 ranks: the large tables sharded, the
    dense layers and small tables replicated (equal on every rank when
    every rank passes a generator with the same seed), batches of B / D
    samples (training/train_state.make_train_step averages the dense
    gradients). `axis_name` names the mesh axis (or tuple of axes) the
    large tables shard over, as in the JAX package."""

    def __init__(
        self,
        config: DLRMConfig,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
        mesh: Any = None,
        axis_name: Any = "data",
    ) -> None:
        super().__init__()
        device = mesh.device if device is None and mesh is not None else (
            resolve_device(device))
        cfg = config
        self.config = cfg
        self.large_idx = [
            i
            for i, v in enumerate(cfg.vocab_sizes)
            if v >= cfg.embedding_threshold
        ]
        self.small_idx = [
            i
            for i, v in enumerate(cfg.vocab_sizes)
            if v < cfg.embedding_threshold
        ]

        feature_configs = large_feature_configs(cfg)
        self.embedding_layer = (
            DistributedEmbedding(
                feature_configs, generator=generator, device=device,
                mesh=mesh, axis_name=axis_name,
                comm_dtype=cfg.embedding_comm_dtype,
            )
            if feature_configs
            else None
        )
        self.small_embeddings = nn.ModuleDict(
            {
                f"cat_{i}": EmbedReduce(
                    cfg.vocab_sizes[i],
                    cfg.embedding_dim,
                    generator=generator,
                    combiner="sum",
                    device=device,
                    name=f"small_{i}",
                )
                for i in self.small_idx
            }
        )
        self.bottom_mlp = MLP(
            cfg.num_dense_features, cfg.bottom_mlp, generator=generator,
            compute_dtype=cfg.compute_dtype,
            output_dtype=cfg.dense_output_dtype, device=device,
        )
        concat_dim = cfg.bottom_mlp[-1] + cfg.embedding_dim * len(
            cfg.vocab_sizes
        )
        self.dcn_layers = nn.ModuleList(
            FeatureCross(
                concat_dim,
                generator=generator,
                projection_dim=cfg.dcn_projection_dim,
                compute_dtype=cfg.compute_dtype,
                output_dtype=cfg.dense_output_dtype,
                device=device,
            )
            for _ in range(cfg.num_dcn_layers)
        )
        self.top_mlp = MLP(
            concat_dim, cfg.top_mlp, generator=generator,
            compute_dtype=cfg.compute_dtype,
            output_dtype=cfg.dense_output_dtype, device=device,
        )
        self.device = device

    def _split(self, batch: dict) -> tuple[dict, dict]:
        """(the batch without the large features, the large features)."""
        large = {f"cat_{i}": batch[f"cat_{i}"] for i in self.large_idx}
        return {k: v for k, v in batch.items() if k not in large}, large

    def preprocess_host(self, batch: dict, training: bool = False) -> dict:
        """Host part of `preprocess` (numpy arrays only, safe on loader
        threads): COO-preprocess the large features. With `training` the
        embedding layer grows its capacities so that no id is dropped
        (its `auto_grow`; growth holds the layer's lock)."""
        out, large = self._split(batch)
        if self.embedding_layer is not None:
            out["large_pre"] = self.embedding_layer.preprocess_host(
                large, training=training)
        return out

    def to_device(self, host_batch: dict) -> dict:
        """A `preprocess_host` result, or a raw numpy batch, on the
        model's device (through pinned memory)."""
        return {
            k: (self.embedding_layer.to_device(v) if k == "large_pre"
                else to_device(np.asarray(v), self.device))
            for k, v in host_batch.items()
        }

    def preprocess(self, batch: dict, training: bool = False) -> dict:
        """Host-side step: COO-preprocess the large features and move the
        batch to the model's device. `batch` holds numpy arrays: "dense"
        [B, 13] f32, "cat_i" [B, L_i] ints and optionally "label" [B].
        `training` goes to the embedding layer, as in the JAX model."""
        return self.to_device(self.preprocess_host(batch, training))

    def preprocess_on_device(self, batch: dict) -> dict:
        """The same from a batch already on the device (`to_device` of the
        raw numpy batch): the COO transform runs on the device, so it can
        run inside the training step, as in
        `bce_loss(m, m.preprocess_on_device(b))`."""
        out, large = self._split(batch)
        if self.embedding_layer is not None:
            out["large_pre"] = self.embedding_layer.preprocess_on_device(
                large
            )
        return out

    def forward(self, batch: dict) -> torch.Tensor:
        """Returns logits (pre-sigmoid) [B] for a preprocessed batch, or
        for one whose "large_acts" holds the large features' activations
        (then the embedding layer is not used)."""
        parts = [self.bottom_mlp(batch["dense"])]
        if "large_acts" in batch:
            acts = batch["large_acts"]
        elif self.embedding_layer is not None:
            acts = self.embedding_layer(batch["large_pre"])
        else:
            acts = {}
        for i in range(len(self.config.vocab_sizes)):
            name = f"cat_{i}"
            if i in self.large_idx:
                parts.append(acts[name])
            else:
                parts.append(self.small_embeddings[name](batch[name]))
        x0 = torch.cat(parts, dim=-1)
        if self.config.dense_output_dtype is not None:
            # bf16-resident DCN/top-MLP stream: one cast at the concat.
            x0 = x0.to(_dtype(self.config.dense_output_dtype))
        x = x0
        for layer in self.dcn_layers:
            x = layer(x0, x)
        return self.top_mlp(x)[..., 0]


def bce_loss(model: DLRMDCNv2, batch: dict) -> torch.Tensor:
    """Sigmoid binary cross-entropy on logits (mean over the batch)."""
    logits = model(batch)
    labels = batch["label"]
    return torch.mean(
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
