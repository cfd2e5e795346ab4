"""Multi-task recommender: joint retrieval and ranking, as a walkthrough.

The port of examples/multi_task.py: one two-tower backbone shared by two
heads, a retrieval task (in-batch sampled softmax on user / item
co-occurrence) and a ranking task (an MLP over both tower outputs
regressing the rating), trained on a weighted sum of the two losses. The
experiment is the reference's loss-weight sweep: a rating specialist, a
retrieval specialist and a joint model, each evaluated on both tasks on
held-out events. The events come from `synthetic.implicit_feedback`
with ratings from the same latent affinity that drives the item choice,
so the two signals share structure and transfer is observable.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.multi_task                 # cuda:0
  python -m keras_rs_tpu_torch.examples.multi_task --device cpu
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.models.two_tower import (
    TwoTower,
    in_batch_softmax_loss,
)
from keras_rs_tpu_torch.training.train_state import DenseAdagrad
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

SWEEP = {
    "rating only   (0, 1)": (0.0, 1.0),
    "retrieval only(1, 0)": (1.0, 0.0),
    "joint         (1, 1)": (1.0, 1.0),
}


class MultiTaskModel(nn.Module):
    """A shared two-tower backbone and a rating head that reads both
    tower outputs (it may use interactions the dot product cannot
    see)."""

    def __init__(self, num_users: int, num_items: int, dim: int, *,
                 generator: torch.Generator | None = None,
                 device: Any = None) -> None:
        super().__init__()
        self.towers = TwoTower(num_users, num_items, dim,
                               generator=generator, device=device)
        self.rating_head = MLP(2 * dim, (64, 1), generator=generator,
                               device=device)

    def rating(self, user_ids: torch.Tensor,
               item_ids: torch.Tensor) -> torch.Tensor:
        q = self.towers.query_tower(user_ids)
        c = self.towers.candidate_tower(item_ids)
        return self.rating_head(torch.cat([q, c], dim=-1))[..., 0]


def make_loss(retrieval_weight: float, rating_weight: float):
    """The weighted multi-task objective."""

    def loss_fn(model: MultiTaskModel, batch: dict) -> torch.Tensor:
        loss = 0.0
        if retrieval_weight:
            loss = loss + retrieval_weight * in_batch_softmax_loss(
                model.towers, batch["user_id"], batch["item_id"])
        if rating_weight:
            pred = model.rating(batch["user_id"], batch["item_id"])
            loss = loss + rating_weight * torch.mean(
                (pred - batch["rating"]) ** 2)
        return loss

    return loss_fn


def train_and_eval(weights, train, test, num_users, num_items, device,
                   epochs: int = 5, seed: int = 0) -> tuple[float, float]:
    """(held-out rating RMSE, held-out recall@10) of one weighting."""
    model = MultiTaskModel(num_users, num_items, 32, device=device,
                           generator=torch.Generator(device).manual_seed(
                               seed))
    trainer = Trainer(model, DenseAdagrad(model.parameters(), 0.1),
                      make_loss(*weights))
    trainer.fit(lambda: synthetic.batches(train, 512, seed=1),
                epochs=epochs, log_every=0)
    users = torch.from_numpy(test["user_id"]).to(device)
    items = torch.from_numpy(test["item_id"]).to(device)
    with torch.no_grad():
        pred = model.rating(users, items).cpu().numpy()
        _, top = model.towers.make_retrieval(k=10)(
            model.towers.query_tower(users))
    rmse = float(np.sqrt(np.mean((pred - test["rating"]) ** 2)))
    top = top.cpu().numpy()
    recall = float(np.mean([test["item_id"][j] in top[j]
                            for j in range(len(top))]))
    return rmse, recall


def main(device=None, epochs: int = 5, num_events: int = 24_000) -> float:
    """Runs the sweep; returns the joint model's held-out rating RMSE."""
    device = resolve_device(device)
    num_users, num_items = 300, 300
    fb = synthetic.implicit_feedback(
        num_users=num_users, num_items=num_items, num_events=num_events,
        holdout_per_user=4, seed=0, with_ratings=True)
    train = {"user_id": fb["user_id"], "item_id": fb["item_id"],
             "rating": fb["rating"]}
    test = {"user_id": fb["eval_user_id"], "item_id": fb["eval_item_id"],
            "rating": fb["eval_rating"]}
    results = {}
    for name, weights in SWEEP.items():
        rmse, recall = train_and_eval(weights, train, test, num_users,
                                      num_items, device, epochs=epochs)
        results[name] = (rmse, recall)
        print(f"{name}: held-out rating RMSE {rmse:.4f}, "
              f"recall@10 {recall:.3f}")
    joint_rmse, _ = results["joint         (1, 1)"]
    print(f"joint loss: n/a, rating RMSE: {joint_rmse:.4f}")
    return joint_rmse


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=5)
    args = parser.parse_args()
    main(args.device, args.epochs)
