"""Data-parallel retrieval over ranks.

The port of examples/data_parallel_retrieval.py: the basic two-tower
retrieval model trained data parallel, one process per device. Every
rank builds the same replica (the same generator seed, then a broadcast
from rank 0, as the JAX example replicates the model over its mesh),
takes its rows of each global batch (`fit(prefetch_sharding=mesh)`),
and the dense gradients are summed over the ranks. The in-batch softmax
is the JAX step's over the global batch: each rank's queries score
against every rank's candidates (models/two_tower.py). Prints the final
loss and the held-out recall@10.

Run from the repository root:
  torchrun --nproc_per_node 2 -m \\
      keras_rs_tpu_torch.examples.data_parallel_retrieval --device cpu
  torchrun --nproc_per_node 2 -m \\
      keras_rs_tpu_torch.examples.data_parallel_retrieval    # a card each
On one card, two ranks need `--device cuda:0 --dist_backend gloo`.
Without a launcher it runs as one rank.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.two_tower import (
    TwoTower,
    in_batch_softmax_loss,
)
from keras_rs_tpu_torch.parallel import mesh as mesh_lib
from keras_rs_tpu_torch.parallel import multihost
from keras_rs_tpu_torch.training.train_state import DenseAdagrad
from keras_rs_tpu_torch.training.trainer import Trainer

NUM_USERS = NUM_ITEMS = 512
BATCH = 512


def main(device: Any = None, dist_backend: str | None = None,
         epochs: int = 10,
         params: Mapping[str, np.ndarray] | None = None) -> dict:
    """Trains and evaluates; returns {"loss": [per epoch], "recall"}.
    `params` (numpy arrays by parameter name, e.g. the JAX example's
    initial weights) replaces the drawn initial weights."""
    device = multihost.rank_device(device)
    started = not dist.is_initialized() and multihost.initialize(
        device, dist_backend)
    mesh = mesh_lib.create_mesh(device)
    rank0 = multihost.process_index() == 0
    if rank0:
        print(f"mesh: {mesh.size} ranks")
    fb = synthetic.implicit_feedback(
        num_users=NUM_USERS, num_items=NUM_ITEMS, num_events=40_960,
        seed=0)
    model = TwoTower(NUM_USERS, NUM_ITEMS, 32, device=device,
                     generator=torch.Generator(device).manual_seed(0))
    if params is not None:
        convert.load_params(model, params)
    mesh_lib.replicate(mesh, [p.data for p in model.parameters()])

    def loss_fn(m: TwoTower, batch: dict) -> torch.Tensor:
        return in_batch_softmax_loss(m, batch["user_id"], batch["item_id"],
                                     mesh=mesh)

    trainer = Trainer(model, DenseAdagrad(model.parameters(), 0.5),
                      loss_fn, mesh=mesh)
    train = {"user_id": fb["user_id"], "item_id": fb["item_id"]}
    hist = trainer.fit(lambda: synthetic.batches(train, BATCH, seed=1),
                       epochs=epochs, log_every=0, prefetch=2,
                       prefetch_sharding=mesh)
    # Held-out recall@10 (stochastic preferences: a ceiling below 1.0).
    retrieval = model.make_retrieval(k=10)
    with torch.no_grad():
        users = torch.from_numpy(fb["eval_user_id"]).to(device)
        _, top = retrieval(model.query_tower(users))
    top = top.cpu().numpy()
    recall = float(np.mean([fb["eval_item_id"][j] in top[j]
                            for j in range(len(fb["eval_user_id"]))]))
    if rank0:
        print(f"final loss: {hist['loss'][-1]:.4f}  recall@10: "
              f"{recall:.3f}")
    if started:
        dist.destroy_process_group()
    return {"loss": hist["loss"], "recall": recall}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:LOCAL_RANK)")
    parser.add_argument("--dist_backend", default=None,
                        help="default nccl on CUDA, gloo on the CPU")
    parser.add_argument("--epochs", type=int, default=10)
    args = parser.parse_args()
    main(args.device, args.dist_backend, args.epochs)
