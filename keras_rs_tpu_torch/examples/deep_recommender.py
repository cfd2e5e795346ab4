"""Deep recommender: multi-feature towers with feature engineering, a
full walkthrough.

The port of examples/deep_recommender.py, in four stages:

  1. FEATURE ENGINEERING on the host, numpy in and integer ids out
     (data/feature_engineering.py): `bucketize` (discretized ages),
     `hash_cross` (user x age bucket), `TextVectorizer` (title tokens);
  2. TOWERS: the query tower embeds the user id, the age bucket and the
     cross; the candidate tower embeds the item id, weighted multi-hot
     genres (mean combiner) and the title tokens (mean). Each tower
     concatenates and maps through an MLP into a shared space;
  3. TRAINING with the in-batch sampled softmax;
  4. EVALUATION: the candidates are embedded again with the trained
     tower (a retrieval layer holds a snapshot, not a live view), then
     held-out recall@k at k = 5, 10, 50 with a popularity baseline.

The events come from `synthetic.implicit_feedback` (stochastic,
multimodal preferences: held-out recall has a ceiling below 1.0).

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.deep_recommender           # cuda:0
  python -m keras_rs_tpu_torch.examples.deep_recommender --device cpu
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.data.feature_engineering import (
    TextVectorizer,
    bucketize,
    hash_cross,
)
from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)
from keras_rs_tpu_torch.training.train_state import DenseAdagrad
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

CROSS_BINS = 256
AGE_BOUNDARIES = np.linspace(20, 70, 9)  # 10 buckets


class QueryTower(nn.Module):
    """user id ++ age bucket ++ hash_cross(user, age) -> MLP -> R^dim."""

    def __init__(self, num_users: int, num_age_buckets: int, dim: int, *,
                 generator: torch.Generator | None = None,
                 device: Any = None) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.user_emb = EmbedReduce(num_users, dim, **kw)
        self.age_emb = EmbedReduce(num_age_buckets + 1, 8, **kw)
        # The (user x age bucket) cross: age-conditional taste in one
        # table.
        self.cross_emb = EmbedReduce(CROSS_BINS, 8, **kw)
        self.mlp = MLP(dim + 8 + 8, (64, dim), **kw)

    def forward(self, user_ids, age_bucket, cross_ids) -> torch.Tensor:
        return self.mlp(torch.cat([self.user_emb(user_ids),
                                   self.age_emb(age_bucket),
                                   self.cross_emb(cross_ids)], dim=-1))


class CandidateTower(nn.Module):
    """item id ++ weighted multi-hot genres ++ title tokens -> MLP."""

    def __init__(self, num_items: int, num_genres: int, title_vocab: int,
                 dim: int, *, generator: torch.Generator | None = None,
                 device: Any = None) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.item_emb = EmbedReduce(num_items, dim, **kw)
        self.genre_emb = EmbedReduce(num_genres, 8, combiner="mean", **kw)
        self.title_emb = EmbedReduce(title_vocab, 8, combiner="mean", **kw)
        self.mlp = MLP(dim + 8 + 8, (64, dim), **kw)

    def forward(self, item_ids, genres, genre_weights, title_ids,
                title_w) -> torch.Tensor:
        return self.mlp(torch.cat([self.item_emb(item_ids),
                                   self.genre_emb(genres, genre_weights),
                                   self.title_emb(title_ids, title_w)],
                                  dim=-1))


class DeepRecommender(nn.Module):
    def __init__(self, num_users: int, num_items: int, num_genres: int,
                 title_vocab: int, dim: int, *,
                 generator: torch.Generator | None = None,
                 device: Any = None) -> None:
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.query = QueryTower(num_users, 10, dim, **kw)
        self.candidate = CandidateTower(num_items, num_genres, title_vocab,
                                        dim, **kw)


def loss_fn(m: DeepRecommender, batch: dict) -> torch.Tensor:
    """In-batch sampled softmax: each row's item is its positive."""
    q = m.query(batch["user_id"], batch["age_bucket"], batch["cross"])
    c = m.candidate(batch["item_id"], batch["genres"], batch["genre_w"],
                    batch["title_ids"], batch["title_w"])
    return -torch.log_softmax(q @ c.T, dim=-1).diagonal().mean()


def main(device=None, epochs: int = 12, num_events: int = 20_000) -> float:
    """Runs the four stages; returns the held-out recall@10."""
    device = resolve_device(device)
    num_users, num_items, num_genres, dim = 400, 150, 12, 32
    rng = np.random.default_rng(0)
    fb = synthetic.implicit_feedback(
        num_users=num_users, num_items=num_items, num_events=num_events,
        holdout_per_user=2, seed=0)
    user_ids, item_ids = fb["user_id"], fb["item_id"]
    n = len(user_ids)

    # 1. Feature engineering on the host.
    ages = rng.uniform(18, 80, size=n).astype(np.float32)
    age_bucket = bucketize(ages, AGE_BOUNDARIES)
    item_genres = rng.integers(0, num_genres, size=(num_items, 3)).astype(
        np.int32)
    genre_w = np.ones((num_items, 3), np.float32)
    words = ["lion", "space", "war", "love", "king", "night", "return",
             "city", "last", "dream"]
    titles = [f"the {words[i % 10]} {words[(i * 3) % 10]}"
              for i in range(num_items)]
    tv = TextVectorizer(output_sequence_length=4).adapt(titles)
    title_ids, title_w = tv(titles)
    print(f"features: {len(AGE_BOUNDARIES) + 1} age buckets, "
          f"{CROSS_BINS}-bin user x age cross, "
          f"{tv.vocabulary_size}-token title vocab")

    # 2. Towers.
    model = DeepRecommender(num_users, num_items, num_genres,
                            tv.vocabulary_size, dim, device=device,
                            generator=torch.Generator(device).manual_seed(0))

    # 3. In-batch sampled-softmax training.
    trainer = Trainer(model, DenseAdagrad(model.parameters(), 0.2), loss_fn)

    def data():
        idx = np.random.default_rng(1).permutation(n)
        for i in range(0, n, 512):
            j = idx[i:i + 512]
            yield {
                "user_id": user_ids[j],
                "age_bucket": age_bucket[j],
                "cross": hash_cross([user_ids[j], age_bucket[j]],
                                    CROSS_BINS),
                "item_id": item_ids[j],
                "genres": item_genres[item_ids[j]],
                "genre_w": genre_w[item_ids[j]],
                "title_ids": title_ids[item_ids[j]],
                "title_w": title_w[item_ids[j]],
            }

    trainer.fit(data, epochs=epochs, log_every=0)

    # 4. Candidate refresh, then held-out recall@k against popularity.
    def put(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    eval_ages = bucketize(np.full(num_users, 40.0), AGE_BOUNDARIES)
    with torch.no_grad():
        candidates = model.candidate(
            torch.arange(num_items, device=device), put(item_genres),
            put(genre_w), put(title_ids), put(title_w))
        q = model.query(
            torch.arange(num_users, device=device), put(eval_ages),
            put(hash_cross([np.arange(num_users), eval_ages], CROSS_BINS)))
    eu, ei = fb["eval_user_id"], fb["eval_item_id"]
    pop10 = np.argsort(np.bincount(item_ids, minlength=num_items))[-10:]
    recall10 = 0.0
    for k in (5, 10, 50):
        with torch.no_grad():
            _, top = BruteForceRetrieval(candidates, k=k)(q)
        top = top.cpu().numpy()
        r = float(np.mean([ei[j] in top[eu[j]] for j in range(len(eu))]))
        extra = (f"  (popularity baseline "
                 f"{float(np.mean(np.isin(ei, pop10))):.3f})"
                 if k == 10 else "")
        print(f"recall@{k}: {r:.3f}{extra}")
        if k == 10:
            recall10 = r
    return recall10


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=12)
    args = parser.parse_args()
    main(args.device, args.epochs)
