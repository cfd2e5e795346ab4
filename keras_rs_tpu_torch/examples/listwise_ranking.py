"""Listwise ranking: the ranking losses on per-user item lists.

The port of examples/listwise_ranking.py: 5-item lists per user, every
item scored by a two-tower model, trained under objectives of growing
"listwise-ness" and each evaluated on held-out lists by NDCG@5, MAP and
MRR:

  pointwise  plain MSE on the ratings (no list structure);
  pairwise   PairwiseMeanSquaredError, PairwiseHingeLoss,
             PairwiseLogisticLoss (all O(L^2) pair comparisons);
  listwise   ListMLELoss (the Plackett-Luce likelihood of the
             label-sorted permutation).

The lists come from one latent-factor universe with rating noise of
sigma 0.5 on the [0, 5] scale, so the ideal ranking is only partly
recoverable: the metrics sit off 1.0 (a random ranking of 5 items scores
NDCG ~0.75, so read the gaps). MAP and MRR take binary relevance: the
list's top-rated item(s).

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.listwise_ranking           # cuda:0
  python -m keras_rs_tpu_torch.examples.listwise_ranking --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from keras_rs_tpu_torch.losses.list_mle_loss import ListMLELoss
from keras_rs_tpu_torch.losses.pairwise_losses import (
    PairwiseHingeLoss,
    PairwiseLogisticLoss,
    PairwiseMeanSquaredError,
)
from keras_rs_tpu_torch.metrics.ranking_metrics import (
    NDCG,
    MeanAveragePrecision,
    MeanReciprocalRank,
)
from keras_rs_tpu_torch.models.two_tower import TwoTower
from keras_rs_tpu_torch.training.train_state import DenseAdagrad
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device


def make_lists(list_size=5, num_lists=2000, seed=0):
    """(users [N], items [N, L], ratings [N, L]) from one fixed
    latent-factor universe (the same factors for every split), with
    rating noise."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 200, size=num_lists).astype(np.int32)
    items = rng.integers(0, 100, size=(num_lists, list_size)).astype(
        np.int32)
    rng2 = np.random.default_rng(0)  # the fixed universe
    u_f = rng2.normal(size=(200, 4)) / 2.0
    i_f = rng2.normal(size=(100, 4)) / 2.0
    labels = np.einsum("ld,lkd->lk", u_f[users], i_f[items]) + (
        0.25 * rng.normal(size=items.shape))
    labels = np.clip(2.5 + 2 * labels, 0, 5).astype(np.float32)
    return users, items, labels


def item_scores(model: TwoTower, users: torch.Tensor,
                items: torch.Tensor) -> torch.Tensor:
    """[B, L] scores: the candidate tower runs on the flattened ids (it
    must not reduce the list axis), then takes the [B, L] shape back."""
    B, L = items.shape
    q = model.query_tower(users)[:, None, :]
    c = model.candidate_tower(items.reshape(-1)).reshape(B, L, -1)
    return (q * c).sum(dim=-1)


def make_loss(loss_obj, pointwise: bool = False):
    def loss_fn(model, batch):
        users, items, labels = batch
        scores = item_scores(model, users, items)
        if pointwise:
            return ((scores - labels) ** 2).mean()
        return loss_obj(labels, scores)
    return loss_fn


def train(loss_obj, users, items, labels, device, *, pointwise=False,
          epochs: int = 10) -> TwoTower:
    model = TwoTower(200, 100, 16, device=device,
                     generator=torch.Generator(device).manual_seed(1))
    trainer = Trainer(model, DenseAdagrad(model.parameters(), 0.3),
                      make_loss(loss_obj, pointwise))

    def data():
        for i in range(0, len(users), 256):
            yield users[i:i + 256], items[i:i + 256], labels[i:i + 256]

    trainer.fit(data, epochs=epochs, log_every=0)
    return model


@torch.no_grad()
def evaluate(model, users, items, labels, device) -> dict[str, float]:
    scores = item_scores(model, torch.from_numpy(users).to(device),
                         torch.from_numpy(items).to(device))
    binary = (labels >= labels.max(axis=1, keepdims=True) - 1e-6).astype(
        np.float32)
    out = {}
    for name, metric, y in (
        ("NDCG@5", NDCG(k=5, shuffle_ties=False, device=device), labels),
        ("MAP", MeanAveragePrecision(shuffle_ties=False, device=device),
         binary),
        ("MRR", MeanReciprocalRank(shuffle_ties=False, device=device),
         binary),
    ):
        metric.update_state(torch.from_numpy(y).to(device), scores)
        out[name] = float(metric.result())
    return out


def main(device=None, epochs: int = 10, num_lists: int = 2000) -> float:
    """Trains one model per objective; returns the best held-out
    NDCG@5."""
    device = resolve_device(device)
    users, items, labels = make_lists(num_lists=num_lists, seed=0)
    eval_lists = make_lists(num_lists=500, seed=7)  # held out
    objectives = [
        ("pointwise MSE", None, True),
        ("pairwise MSE", PairwiseMeanSquaredError(), False),
        ("pairwise hinge", PairwiseHingeLoss(), False),
        ("pairwise logistic", PairwiseLogisticLoss(), False),
        ("ListMLE", ListMLELoss(), False),
    ]
    results = {}
    header = f"{'objective':18s}  NDCG@5   MAP     MRR"
    print(header)
    print("-" * len(header))
    for name, loss_obj, pointwise in objectives:
        model = train(loss_obj, users, items, labels, device,
                      pointwise=pointwise, epochs=epochs)
        m = evaluate(model, *eval_lists, device)
        results[name] = m
        print(f"{name:18s}  {m['NDCG@5']:.4f}  {m['MAP']:.4f}  "
              f"{m['MRR']:.4f}")
    best = max(results, key=lambda k: results[k]["NDCG@5"])
    print(f"best NDCG@5: {best} ({results[best]['NDCG@5']:.4f})")
    return results[best]["NDCG@5"]


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=10)
    args = parser.parse_args()
    main(args.device, args.epochs)
