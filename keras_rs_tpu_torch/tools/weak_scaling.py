"""Weak-scaling communication accounting over gloo ranks.

The port of tools/weak_scaling.py. For D = 1, 2, 4 and 8 ranks at a
fixed per-device batch (weak scaling), every rank builds the same small
hybrid DLRM-DCNv2 (`MODEL`, the config of __graft_entry__.py's
`_make_model_and_batch`), takes its rows of one seed-0
`criteo_like_batch` of the global batch and runs one data-parallel
training step: the device COO transform (one all_to_all per stack), the
lookup (a reduce-scatter forward, an all-gather backward), the dense
stack, the backward, the dense gradients' all_reduce and the loss's.
`parallel.collectives.count_bytes` counts each collective's output bytes
per rank by kind, as the JAX tool sums the output shapes of the compiled
step's collectives; `torch.utils.flop_counter.FlopCounterMode` counts
the step's FLOPs (matrix products only; printed, not compared with
XLA's cost model).

Per rank and step, with B_l the per-device batch, F = 2 large features,
dim 64 and C = 2,048 the bucket capacity:
  all-to-all      D * 3 * C * 4 bytes (slots, segments and gains of every
                  bucket, int32-sized, in one exchange)
  reduce-scatter  B_l * F * dim * (4 or 2 with comm_dtype="bfloat16")
  all-gather      D * B_l * F * dim * (4 or 2)
  all-reduce      (338,497 dense parameters + the loss) * 4
The JAX tool's figures at D = 2, 4 and 8 are the same. At D = 1 a rank
runs no collective (a one-rank group is the identity), where XLA keeps a
trivial all-gather of 32,768 bytes in the JAX step. The port sends the
dtype it is asked for, so its bf16 rows are the JAX tool's "requested"
rows (XLA's CPU backend runs bf16 collectives in f32).

The ranks are spawned processes joined by gloo over localhost. They
run on cuda:0 by default (one card holds every rank; gloo carries the
path's collectives on CUDA tensors, and the counts do not depend on the
device) and raise where CUDA is absent; `--device cpu` runs them on the
CPU.

Usage: python -m keras_rs_tpu_torch.tools.weak_scaling [--device cpu]
(spawns up to 8 processes; about 15 s on the CPU)
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import socket
import traceback
from typing import Any

#: __graft_entry__._make_model_and_batch's DLRMConfig (large_vocab
#: 200,000, embedding_dim 64, threshold 21,000).
MODEL = dict(
    vocab_sizes=[200_000, 1000, 50_000, 500],
    multi_hot_sizes=[3, 1, 2, 1],
    num_dense_features=13,
    embedding_dim=64,
    bottom_mlp=(256, 128, 64),
    top_mlp=(256, 128, 1),
    num_dcn_layers=2,
    dcn_projection_dim=64,
    embedding_threshold=21_000,
    max_ids_per_partition=2048,
    max_unique_ids_per_partition=2048,
    learning_rate=0.0034,
    table_placement="sharded",
)
#: The JAX tool's dense optimizer, optax.adagrad(0.01).
DENSE_LR = 0.01
COUNTS = (1, 2, 4, 8)
PER_DEVICE_BATCH = 64
RANK_TIMEOUT_S = 300.0


def counted_step(rank: int, world: int,
                 per_device_batch: int = PER_DEVICE_BATCH,
                 comm_dtype: str | None = None,
                 device: Any = None) -> dict[str, Any]:
    """One training step of `MODEL` on this rank of `world` (the default
    process group, already joined; none for one rank), on `device`
    (default cuda:0, utils/device.py): {"per_kind": bytes by collective
    kind, "flops": the step's FLOPs, "loss": the global batch's loss}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from keras_rs_tpu_torch.data import synthetic
    from keras_rs_tpu_torch.models import dlrm
    from keras_rs_tpu_torch.parallel import collectives
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.training.train_state import (
        DenseAdagrad,
        make_train_step,
    )
    from keras_rs_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    batch = per_device_batch * world
    mesh = mesh_lib.create_mesh(device)
    if mesh.size != world:
        raise RuntimeError(f"{mesh.size} ranks in the mesh, {world} asked")
    model = dlrm.DLRMDCNv2(
        dlrm.DLRMConfig(global_batch_size=batch,
                        embedding_comm_dtype=comm_dtype, **MODEL),
        generator=torch.Generator(device).manual_seed(0), device=device,
        mesh=mesh)
    raw = synthetic.criteo_like_batch(
        batch, vocab_sizes=MODEL["vocab_sizes"],
        multi_hot_sizes=MODEL["multi_hot_sizes"], seed=0)
    local = mesh_lib.put_batch(mesh, raw)

    def loss_fn(m, b):
        return dlrm.bce_loss(m, m.preprocess_on_device(b))

    step = make_train_step(model, loss_fn,
                           DenseAdagrad(model.parameters(), DENSE_LR),
                           mesh=mesh)
    with collectives.count_bytes() as counts, \
            FlopCounterMode(display=False) as flops:
        loss = float(step(local))
    return {"per_kind": dict(counts), "flops": flops.get_total_flops(),
            "loss": loss}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, per_device_batch: int,
               comm_dtypes: tuple, device: str, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.pop("WORLD_SIZE", None)  # this rank's group is its own
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world)
        try:
            conn.send(("ok", [counted_step(rank, world, per_device_batch, d,
                                           device)
                              for d in comm_dtypes]))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def run_ranks(n_devices: int, per_device_batch: int = PER_DEVICE_BATCH,
              comm_dtypes: tuple = (None,),
              device: Any = None) -> list[list[dict]]:
    """`counted_step` on `n_devices` spawned gloo ranks, each on
    `device` (default cuda:0; raises here without CUDA), for each of
    `comm_dtypes` in turn; the results by rank, then by dtype. A rank
    that fails or hangs fails the call (the others are killed)."""
    from keras_rs_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    ctx = mp.get_context("spawn")
    port = _free_port()
    conns, procs = [], []
    for rank in range(n_devices):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_rank_main, args=(
            rank, n_devices, port, per_device_batch, tuple(comm_dtypes),
            device, child), daemon=True)
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)
    try:
        out = []
        for rank, conn in enumerate(conns):
            if not conn.poll(RANK_TIMEOUT_S):
                raise TimeoutError(f"rank {rank} of {n_devices} gave no "
                                   f"answer in {RANK_TIMEOUT_S} s")
            status, value = conn.recv()
            if status != "ok":
                raise RuntimeError(f"rank {rank} of {n_devices}:\n{value}")
            out.append(value)
        return out
    finally:
        for p in procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join()


def _row(n: int, per_device_batch: int, ranks: list[dict]) -> dict:
    """The JAX tool's row from every rank's counts (which must agree:
    every rank runs the same collectives on the same shapes)."""
    kinds = ranks[0]["per_kind"]
    if any(r["per_kind"] != kinds for r in ranks):
        raise RuntimeError(f"ranks counted different bytes at D = {n}: "
                           f"{[r['per_kind'] for r in ranks]}")
    total = sum(kinds.values())
    return {
        "n_devices": n,
        "global_batch": per_device_batch * n,
        "per_device_batch": per_device_batch,
        "collective_bytes_per_device": total,
        "per_kind_per_device": kinds,
        # What the port sends is what was asked for.
        "requested_per_kind_per_device": kinds,
        "flops_per_device": float(ranks[0]["flops"]),
        "comm_bytes_per_local_example": total / per_device_batch,
    }


def main(argv: list[str] | None = None) -> dict[str, list[dict]]:
    """Prints the two tables and the JSON line for D in `COUNTS`;
    returns the JSON line's object."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="every rank's torch device (default cuda:0)")
    args = parser.parse_args(argv)
    rows32, rows16 = [], []
    for n in COUNTS:
        ranks = run_ranks(n, PER_DEVICE_BATCH, (None, "bfloat16"),
                          args.device)
        rows32.append(_row(n, PER_DEVICE_BATCH, [r[0] for r in ranks]))
        rows16.append(_row(n, PER_DEVICE_BATCH, [r[1] for r in ranks]))
    print("-- executed collectives (gloo ranks, comm f32) --")
    print(
        f"{'n':>2} {'batch':>6} {'a2a/dev':>12} {'ar(buf)':>12} "
        f"{'ag/dev':>12} {'rs/dev':>12} {'total/dev':>12} "
        f"{'B/loc.ex':>10}"
    )
    for r in rows32:
        k = r["per_kind_per_device"]
        print(
            f"{r['n_devices']:>2} {r['global_batch']:>6} "
            f"{k['all-to-all']:>12,} {k['all-reduce']:>12,} "
            f"{k['all-gather']:>12,} {k['reduce-scatter']:>12,} "
            f"{r['collective_bytes_per_device']:>12,} "
            f"{r['comm_bytes_per_local_example']:>10,.0f}"
        )
    print("-- embedding-exchange wire bytes (the dtype each rank sends) --")
    print(
        f"{'n':>2} {'ag f32':>12} {'ag bf16':>12} {'rs f32':>12} "
        f"{'rs bf16':>12} {'a2a (both)':>12}"
    )
    for r32, r16 in zip(rows32, rows16):
        k32 = r32["requested_per_kind_per_device"]
        k16 = r16["requested_per_kind_per_device"]
        print(
            f"{r32['n_devices']:>2} {k32['all-gather']:>12,} "
            f"{k16['all-gather']:>12,} {k32['reduce-scatter']:>12,} "
            f"{k16['reduce-scatter']:>12,} {k16['all-to-all']:>12,}"
        )
    out = {"weak_scaling_float32": rows32,
           "weak_scaling_comm_bfloat16": rows16}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
