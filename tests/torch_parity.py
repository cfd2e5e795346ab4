"""Shared helpers of the tests that hold keras_rs_tpu_torch to keras_rs_tpu.

Importing this module runs torch on one CPU thread, so the port's tests
stay small next to the JAX suite and every float sum is taken by one
thread: with a second intra-op thread, a batched matmul occasionally
(about one process in twelve, after the JAX package's interpret-mode
Pallas tests ran in the same process) returned the half computed on that
thread ~5e-5 off, in a repeatable pattern. Inputs are made with numpy
from a seed and handed to both packages; parameters move from the JAX
model to the port with keras_rs_tpu_torch.convert.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import torch

torch.set_num_threads(1)

from keras_rs_tpu import training as jax_training  # noqa: E402
from keras_rs_tpu.models import dlrm as jax_dlrm  # noqa: E402
from keras_rs_tpu.parallel import mesh as mesh_lib  # noqa: E402
from keras_rs_tpu_torch import convert  # noqa: E402
from keras_rs_tpu_torch.models import dlrm as torch_dlrm  # noqa: E402
from keras_rs_tpu_torch.training import train_state  # noqa: E402

B = 64
VOCAB = [2000, 1500, 50, 30]
MULTI_HOT = [3, 2, 1, 2]
THRESHOLD = 1000
DIM = 128  # the packed state layout needs dim % 128 == 0
LR = 0.05


def one_device_mesh():
    """D = 1: conftest forces 8 virtual CPU devices, so mesh=None would
    give D = 8."""
    return mesh_lib.create_mesh(jax.devices()[:1])


def dlrm_config_kwargs(**overrides):
    kw = dict(
        vocab_sizes=VOCAB,
        multi_hot_sizes=MULTI_HOT,
        num_dense_features=13,
        embedding_dim=DIM,
        bottom_mlp=(64, DIM),
        top_mlp=(64, 32, 1),
        num_dcn_layers=2,
        dcn_projection_dim=32,
        embedding_threshold=THRESHOLD,
        # Worst-case capacities (every id of the batch unique), as the
        # slice sets them: nothing is dropped.
        max_ids_per_partition=B * 5,
        max_unique_ids_per_partition=B * 5,
        learning_rate=LR,
        global_batch_size=B,
        table_placement="sharded",
    )
    kw.update(overrides)
    return kw


def jax_dlrm_params(model) -> tuple[dict, dict]:
    """(params by the port's parameter names, logical tables by name)."""
    params = {}
    for tower in ("bottom_mlp", "top_mlp"):
        for i, layer in enumerate(getattr(model, tower).layers):
            params[f"{tower}.layers.{i}.kernel"] = np.asarray(layer.kernel)
            params[f"{tower}.layers.{i}.bias"] = np.asarray(layer.bias)
    for i, layer in enumerate(model.dcn_layers):
        params[f"dcn_layers.{i}.down_proj_kernel"] = np.asarray(
            layer.down_proj_kernel
        )
        params[f"dcn_layers.{i}.kernel"] = np.asarray(layer.kernel)
        params[f"dcn_layers.{i}.bias"] = np.asarray(layer.bias)
    for name, er in model.small_embeddings.items():
        params[f"small_embeddings.{name}.embeddings"] = np.asarray(
            er.embeddings
        )
    tables = {
        k: np.asarray(v)
        for k, v in model.embedding_layer.get_embedding_tables().items()
    }
    return params, tables


def jax_stack_states(layer) -> dict:
    """A JAX DistributedEmbedding's raw stack states as numpy arrays
    (bf16 tables stay ml_dtypes.bfloat16), keyed by stack name."""
    return {
        name: {
            "table": np.asarray(st["table"]),
            "step": np.asarray(st["step"]),
            **({"slots": {k: np.asarray(v) for k, v in st["slots"].items()}}
               if "slots" in st else {}),
        }
        for name, st in layer.state.value.items()
    }


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The bf16 spacing at |a| (8 significant bits), for normal values."""
    m = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def assert_within_bf16_ulps(got, want, ulps: float = 1.0) -> None:
    """|got - want| <= ulps bf16 spacings at the larger magnitude."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bound = ulps * bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    over = np.abs(got - want) > bound
    assert not over.any(), (
        f"{int(over.sum())} of {over.size} values differ by more than "
        f"{ulps} bf16 ulp; worst {np.abs(got - want)[over].max()!r}"
    )


def build_pair(seed: int = 0, carry_states: bool = False, **overrides):
    """A JAX DLRM on one device and the port's DLRM with its parameters:
    logical tables through `tables`, or (`carry_states`) the whole stack
    states, where the two layouts match."""
    kw = dlrm_config_kwargs(**overrides)
    jmodel = jax_dlrm.DLRMDCNv2(
        jax_dlrm.DLRMConfig(**kw),
        key=jax.random.key(seed),
        mesh=one_device_mesh(),
    )
    tmodel = torch_dlrm.DLRMDCNv2(
        torch_dlrm.DLRMConfig(**kw),
        generator=torch.Generator().manual_seed(seed),
        device="cpu",
    )
    params, tables = jax_dlrm_params(jmodel)
    if carry_states:
        convert.load_params(
            tmodel, params,
            states=jax_stack_states(jmodel.embedding_layer),
        )
    else:
        convert.load_params(tmodel, params, tables)
    return jmodel, tmodel


def train_jax(jmodel, lr, batches):
    """Losses of one JAX train step per raw batch (optax.adagrad)."""
    opt = optax.adagrad(lr)
    state = jax_training.create_train_state(jmodel, opt)
    step = jax_training.make_train_step(jax_dlrm.bce_loss, opt, donate=False)
    losses = []
    for raw in batches:
        state, loss = step(state, state.model.preprocess(raw))
        losses.append(float(loss))
    return losses, state.model


def train_torch(tmodel, lr, batches):
    """Losses of one port train step per raw batch (DenseAdagrad)."""
    opt = train_state.DenseAdagrad(tmodel.parameters(), lr)
    step = train_state.make_train_step(tmodel, torch_dlrm.bce_loss, opt)
    return [float(step(tmodel.preprocess(raw))) for raw in batches]


def jax_attr(obj, dotted: str):
    """`obj.a.0.b` for the dotted path "a.0.b" (digits index lists)."""
    for part in dotted.split("."):
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    return obj


def load_from_jax(tmodule, jmodule):
    """Copies into each of `tmodule`'s parameters the JAX module's array
    at the same attribute path (Dense, MLP, FeatureCross, GRU, GRU4Rec
    keep the JAX names and layouts); returns `tmodule`."""
    convert.load_params(tmodule, {
        name: np.asarray(jax_attr(jmodule, name))
        for name, _ in tmodule.named_parameters()
    })
    return tmodule


def jax_block_params(block, prefix: str = "") -> dict:
    """A JAX TransformerBlock's arrays by the port's parameter names."""
    a = block.attention
    params = {f"{prefix}attention.{w}": np.asarray(getattr(a, w))
              for w in ("wq", "wk", "wv", "wo")}
    for norm in ("norm1", "norm2"):
        for f in ("scale", "offset"):
            params[f"{prefix}{norm}.{f}"] = np.asarray(
                getattr(getattr(block, norm), f))
    for dense in ("mlp_in", "mlp_out"):
        for f in ("kernel", "bias"):
            params[f"{prefix}{dense}.{f}"] = np.asarray(
                getattr(getattr(block, dense), f))
    return params


def jax_sasrec_params(model) -> dict:
    """A JAX SASRec's arrays by the port's parameter names (attention
    weights are [D, D] used as x @ w on both sides: no transpose)."""
    params = {
        "item_embedding.embeddings": np.asarray(
            model.item_embedding.embeddings),
        "position_embedding.embeddings": np.asarray(
            model.position_embedding.embeddings),
        "final_norm.scale": np.asarray(model.final_norm.scale),
        "final_norm.offset": np.asarray(model.final_norm.offset),
    }
    for i, block in enumerate(model.blocks):
        params.update(jax_block_params(block, f"blocks.{i}."))
    return params


def jax_mlp_params(mlp, prefix: str) -> dict:
    """A JAX MLP's arrays by the port's names ("<prefix>layers.i.kernel")."""
    params = {}
    for i, layer in enumerate(mlp.layers):
        params[f"{prefix}layers.{i}.kernel"] = np.asarray(layer.kernel)
        params[f"{prefix}layers.{i}.bias"] = np.asarray(layer.bias)
    return params


def jax_two_tower_params(model) -> dict:
    """A JAX TwoTower's arrays by the port's parameter names."""
    params = {
        "query_embedding.embeddings": np.asarray(
            model.query_embedding.embeddings),
        "candidate_embedding.embeddings": np.asarray(
            model.candidate_embedding.embeddings),
    }
    if model.query_mlp is not None:
        params.update(jax_mlp_params(model.query_mlp, "query_mlp."))
        params.update(jax_mlp_params(model.candidate_mlp, "candidate_mlp."))
    return params


def jax_basic_ranking_params(model) -> dict:
    """A JAX BasicRanking's arrays by the port's parameter names."""
    return {
        "user_embedding.embeddings": np.asarray(
            model.user_embedding.embeddings),
        "item_embedding.embeddings": np.asarray(
            model.item_embedding.embeddings),
        **jax_mlp_params(model.mlp, "mlp."),
    }


def jax_kmeans_index(layer) -> dict:
    """A JAX KMeansRetrieval's index as numpy arrays (None where the
    layer has none), the input of convert.load_kmeans_index."""
    return {
        name: None if getattr(layer, name) is None
        else np.asarray(getattr(layer, name))
        for name in ("centroids", "cluster_candidates", "cluster_ids",
                     "cluster_valid", "cluster_scales", "cluster_pos",
                     "flat_candidates")
    }
