"""Multi-rank correctness check of the sharded DLRM step (counterpart of
`__graft_entry__.dryrun_multichip` of the JAX package).

`dryrun_multichip(n)` runs in each of n ranks of the default process
group (torchrun, or any launcher that initialized it). Every rank feeds
the same tiny DLRM batch, with the same logical tables, through three
configurations and one training step each:

  (a) a one-rank copy of the model in every rank, on the whole batch;
  (b) the n-rank 1-D mesh ("data"), each rank on its rows;
  (c) the ("model", "data") mesh of sizes (2, n // 2), the tables
      sharded over both axes.

The model is the JAX dry run's, with its dense stack in f32: with bf16
matmuls, a batch split over ranks takes other GEMM kernels on a card
than the whole batch does, which moves the loss by a bf16 ulp, beyond
the bounds below.

It asserts that the activations of (b) match a numpy lookup oracle and
those of (a), that the loss, the post-step tables and the last dense
kernel agree across (a), (b) and (c) at the JAX dry run's bounds, that
the n-rank state round-trips bit for bit through a sharded checkpoint
(training/checkpoint.py), and that bf16 tables with row-wise Adagrad
(the split layout) agree across (a) and (b) within one bf16 ulp of
stochastic rounding. Returns the numbers it compared.

Run (two ranks on the CPU):
  torchrun --nproc_per_node 2 -m keras_rs_tpu_torch.parallel.dryrun \
      --device cpu
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.dlrm import DLRMConfig, DLRMDCNv2, bce_loss
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.parallel import multihost
from keras_rs_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils.device import resolve_device

VOCAB = [4096, 1000, 1024, 500]
MULTI_HOT = [3, 1, 2, 1]
THRESHOLD = 800
LR = 0.01


def _config(batch_size: int, embedding_dim: int = 16,
            table_dtype: str = "float32",
            embedding_optimizer: str = "adagrad") -> DLRMConfig:
    return DLRMConfig(
        vocab_sizes=VOCAB, multi_hot_sizes=MULTI_HOT,
        num_dense_features=13, embedding_dim=embedding_dim,
        bottom_mlp=(256, 128, embedding_dim), top_mlp=(256, 128, 1),
        num_dcn_layers=2, dcn_projection_dim=64,
        embedding_threshold=THRESHOLD, max_ids_per_partition=2048,
        max_unique_ids_per_partition=2048, learning_rate=0.0034,
        global_batch_size=batch_size, table_placement="sharded",
        table_dtype=table_dtype, embedding_optimizer=embedding_optimizer,
        compute_dtype=None, dense_output_dtype="float32",
    )


def _one_rank_mesh(device: torch.device) -> mesh_lib.Mesh:
    """A mesh of this process alone (a D = 1 model inside a group)."""
    return mesh_lib.Mesh((mesh_lib.DATA_AXIS,), (1,), device)


def _run_one_step(mesh: mesh_lib.Mesh, raw: dict, tables: dict,
                  axis_name: Any = mesh_lib.DATA_AXIS, **cfg_kw) -> dict:
    """Builds the tiny DLRM on `mesh` (from seed 0), loads the logical
    `tables`, gathers the activations of this rank's rows and runs ONE
    data-parallel training step; the loss, the activations, the
    post-step tables (all-gathered), the last dense kernel and the
    model."""
    device = mesh.device
    batch_size = len(raw["label"])
    model = DLRMDCNv2(_config(batch_size, **cfg_kw),
                      generator=torch.Generator(device).manual_seed(0),
                      device=device, mesh=mesh, axis_name=axis_name)
    model.embedding_layer.set_embedding_tables(tables)
    rows = mesh_lib.batch_rows(mesh, batch_size, mesh.axis_names)
    batch = model.to_device({k: np.asarray(v)[rows]
                             for k, v in raw.items()})
    with torch.no_grad():
        pre = model.preprocess_on_device(batch)
        acts = {k: v.float().cpu().numpy()
                for k, v in model.embedding_layer(pre["large_pre"]).items()}
    step = make_train_step(
        model, lambda m, b: bce_loss(m, m.preprocess_on_device(b)),
        DenseAdagrad(model.parameters(), LR),
        mesh=mesh if mesh.size > 1 else None)
    loss = float(step(batch))
    return {
        "loss": loss,
        "acts": acts,
        "tables": {k: v.float().cpu().numpy() for k, v in
                   model.embedding_layer.get_embedding_tables().items()},
        "dense": model.top_mlp.layers[-1].kernel.detach().cpu().numpy(),
        "model": model,
        "rows": rows,
    }


def _shared_tmpdir() -> str:
    """A new directory under TMPDIR, made by rank 0 and named to all."""
    name = [tempfile.mkdtemp(prefix="dryrun_ckpt_")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    return name[0]


def dryrun_multichip(n_devices: int, device: Any = None) -> dict:
    """The check above in each of the n_devices ranks of the default
    process group (every rank calls it); raises AssertionError on a
    disagreement."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices or n_devices < 2 or n_devices % 2:
        raise ValueError(
            f"dryrun_multichip({n_devices}) needs an even number of at "
            f"least 2 ranks in the process group; it has {world}.")
    device = resolve_device(device)
    batch_size = 8 * n_devices
    raw = synthetic.criteo_like_batch(batch_size, vocab_sizes=VOCAB,
                                      multi_hot_sizes=MULTI_HOT, seed=0)
    rng = np.random.default_rng(0)
    large = [i for i, v in enumerate(VOCAB) if v > THRESHOLD]
    tables = {f"table_{i}": rng.normal(size=(VOCAB[i], 16)).astype(
        np.float32) * 0.05 for i in large}

    one = _run_one_step(_one_rank_mesh(device), raw, tables)
    n = _run_one_step(mesh_lib.create_mesh(device), raw, tables)
    axes2d = ("model", "data")
    mesh2d = mesh_lib.create_mesh(device, axes2d, (2, n_devices // 2))
    two = _run_one_step(mesh2d, raw, tables, axis_name=axes2d)

    # numpy oracle of the n-rank activations (combiner sum).
    for i in large:
        ids = np.asarray(raw[f"cat_{i}"])[n["rows"]]
        np.testing.assert_allclose(
            n["acts"][f"cat_{i}"], tables[f"table_{i}"][ids].sum(axis=1),
            rtol=1e-5, atol=1e-5,
            err_msg=f"cat_{i}: {n_devices}-rank activations vs the oracle")
    for i in large:
        name, tname = f"cat_{i}", f"table_{i}"
        for label, got in (("n-rank", n), ("2-D mesh", two)):
            np.testing.assert_allclose(
                got["acts"][name], one["acts"][name][got["rows"]],
                rtol=1e-5, atol=1e-5,
                err_msg=f"{name}: {label} vs one-rank activations")
            np.testing.assert_allclose(
                got["tables"][tname], one["tables"][tname], rtol=1e-4,
                atol=1e-5, err_msg=f"{tname}: {label} post-step tables")
    for label, got in (("n-rank", n), ("2-D mesh", two)):
        assert abs(got["loss"] - one["loss"]) < 1e-4, (label, got["loss"],
                                                       one["loss"])
        np.testing.assert_allclose(got["dense"], one["dense"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{label} dense")

    # Sharded checkpoint round trip of the n-rank state.
    path = _shared_tmpdir()
    try:
        state = {"model": n["model"]}
        save_checkpoint(os.path.join(path, "state"), state)
        fresh = _run_one_step(mesh_lib.create_mesh(device), raw,
                              {k: v * 2 for k, v in tables.items()})
        restore_checkpoint(os.path.join(path, "state"),
                           {"model": fresh["model"]})
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(path, ignore_errors=True)
    emb, emb_r = n["model"].embedding_layer, fresh["model"].embedding_layer
    for i in range(len(emb.stacks)):
        a, b = emb.stack_state(i), emb_r.stack_state(i)
        assert torch.equal(a["table"], b["table"]), (
            "checkpoint round-trip not bit-identical")
        assert int(b["step"]) == 1, int(b["step"])

    # bf16 tables with row-wise Adagrad (the split layout, kernel B3 on
    # the card) at dim 128: activations equal, tables within one bf16 ulp
    # (each rank rounds its rows stochastically with its own bits).
    tables128 = {k: rng.normal(size=(v.shape[0], 128)).astype(np.float32)
                 * 0.05 for k, v in tables.items()}
    bf = dict(embedding_dim=128, table_dtype="bfloat16",
              embedding_optimizer="rowwise_adagrad")
    b1 = _run_one_step(_one_rank_mesh(device), raw, tables128, **bf)
    bn = _run_one_step(mesh_lib.create_mesh(device), raw, tables128, **bf)
    for i in large:
        name, tname = f"cat_{i}", f"table_{i}"
        np.testing.assert_allclose(
            bn["acts"][name], b1["acts"][name][bn["rows"]], rtol=1e-5,
            atol=1e-5, err_msg=f"{name}: bf16 activations across meshes")
        np.testing.assert_allclose(
            bn["tables"][tname], b1["tables"][tname], rtol=2**-7,
            atol=1e-4, err_msg=f"{tname}: bf16 post-step tables")
    assert abs(bn["loss"] - b1["loss"]) < 1e-3, (bn["loss"], b1["loss"])

    out = {"loss_one": one["loss"], "loss_n": n["loss"],
           "loss_2d": two["loss"], "loss_bf16_one": b1["loss"],
           "loss_bf16_n": bn["loss"]}
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): ok, loss={n['loss']:.5f} "
              f"(1-rank {one['loss']:.5f}, 2-D {two['loss']:.5f}; "
              "activations and tables match the numpy oracle and agree "
              "across meshes; sharded checkpoint round trip bit-identical; "
              f"bf16 + row-wise Adagrad loss {bn['loss']:.5f} vs "
              f"{b1['loss']:.5f})", flush=True)
    return out


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:LOCAL_RANK)")
    parser.add_argument("--dist_backend", default=None,
                        help="default nccl on CUDA, gloo on the CPU")
    args = parser.parse_args(argv)
    device = multihost.rank_device(args.device)
    started = not dist.is_initialized() and multihost.initialize(
        device, args.dist_backend)
    try:
        return dryrun_multichip(multihost.process_count(), device)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
