"""Synthetic datasets for tests and benchmarks (numpy only).

The port's copy of keras_rs_tpu/data/synthetic.py, so the card needs no
JAX; the same seed gives the same arrays in both packages. A
MovieLens-like ratings table with latent user/item factors (so models
can learn), implicit-feedback events, Markov item sessions, and
Criteo-shaped DLRM batches (13 dense + 26 multi-hot categoricals) with
random or learnable CTR labels.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def movielens_like(
    num_users: int = 200,
    num_items: int = 100,
    num_examples: int = 5000,
    latent_dim: int = 4,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Ratings from random latent factors + noise, in [0.5, 5]."""
    rng = np.random.default_rng(seed)
    u_factors = rng.normal(size=(num_users, latent_dim)) / np.sqrt(latent_dim)
    i_factors = rng.normal(size=(num_items, latent_dim)) / np.sqrt(latent_dim)
    user_ids = rng.integers(0, num_users, size=num_examples)
    item_ids = rng.integers(0, num_items, size=num_examples)
    raw = np.sum(u_factors[user_ids] * i_factors[item_ids], axis=-1)
    rating = np.clip(2.75 + 2.0 * raw + 0.1 * rng.normal(size=num_examples),
                     0.5, 5.0)
    return {
        "user_id": user_ids.astype(np.int32),
        "item_id": item_ids.astype(np.int32),
        "rating": rating.astype(np.float32),
    }


def batches(
    data: dict[str, np.ndarray],
    batch_size: int,
    *,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Shuffled mini-batches over a dict-of-arrays dataset."""
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        idx = perm[start : start + batch_size]
        yield {k: v[idx] for k, v in data.items()}


def implicit_feedback(
    num_users: int = 500,
    num_items: int = 1000,
    num_events: int = 60_000,
    latent_dim: int = 8,
    temperature: float = 8.0,
    holdout_per_user: int = 2,
    seed: int = 0,
    with_ratings: bool = False,
) -> dict[str, np.ndarray]:
    """Stochastic implicit-feedback events with a train/eval split.

    Each user samples items from softmax(temperature * u.i) over latent
    factors — preferences are MULTIMODAL, so even a perfect model cannot
    reach recall 1 at small k: quality metrics land off the ceiling and
    stay discriminative (a better model scores higher). This replaces the
    earlier deterministic user->item mapping whose recall@10 saturated
    at ~1.0 (the reference's MovieLens data has the same property:
    held-out interactions are inherently noisy).

    Returns train user/item id arrays plus per-user held-out eval items.
    """
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(num_users, latent_dim)) / np.sqrt(latent_dim)
    v = rng.normal(size=(num_items, latent_dim)) / np.sqrt(latent_dim)
    logits = temperature * (u @ v.T)  # [U, I]
    logits -= logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)

    user_ids = rng.integers(0, num_users, size=num_events)
    # Vectorized categorical sampling via inverse-CDF per event.
    cdf = np.cumsum(probs, axis=1)
    r = rng.random(num_events)
    item_ids = (cdf[user_ids] < r[:, None]).sum(axis=1)

    eval_users = np.repeat(np.arange(num_users), holdout_per_user)
    r_eval = rng.random(len(eval_users))
    eval_items = (cdf[eval_users] < r_eval[:, None]).sum(axis=1)
    out = {
        "user_id": user_ids.astype(np.int32),
        "item_id": item_ids.astype(np.int32),
        "eval_user_id": eval_users.astype(np.int32),
        "eval_item_id": eval_items.astype(np.int32),
    }
    if with_ratings:
        # Ratings from the SAME latent affinity that drives the item
        # choice (plus noise): a multi-task dataset where the retrieval
        # and ranking signals share structure, like real watch+rating
        # logs — training one task genuinely transfers to the other.
        aff = np.sum(u[user_ids] * v[item_ids], axis=-1)
        out["rating"] = np.clip(
            2.75 + 6.0 * aff + 0.3 * rng.normal(size=num_events), 0.5, 5.0
        ).astype(np.float32)
        aff_e = np.sum(u[eval_users] * v[eval_items], axis=-1)
        out["eval_rating"] = np.clip(
            2.75 + 6.0 * aff_e + 0.3 * rng.normal(size=len(eval_users)),
            0.5,
            5.0,
        ).astype(np.float32)
    return out


def markov_sessions(
    num_items: int = 500,
    num_sessions: int = 8192,
    length: int = 10,
    branching: int = 4,
    noise: float = 0.15,
    seed: int = 0,
) -> np.ndarray:
    """Item sequences from a noisy transition graph (1-indexed ids; 0 =
    padding).

    Each item has `branching` plausible successors (uniform among them),
    and with probability `noise` the next item is uniform over the whole
    catalog. Next-item prediction therefore has intrinsic entropy:
    recall@10 is bounded by ~(1 - noise) * min(1, 10 / branching) —
    off the ceiling, discriminative. Returns the full sequences
    [num_sessions, length + 1]; slice [:, :-1] as history and [:, 1:]
    (or [:, -1]) as targets.
    """
    rng = np.random.default_rng(seed)
    successors = rng.integers(
        1, num_items + 1, size=(num_items + 1, branching)
    )
    cur = rng.integers(1, num_items + 1, size=num_sessions)
    steps = []
    for _ in range(length + 1):
        steps.append(cur.copy())
        pick = successors[
            cur, rng.integers(0, branching, size=num_sessions)
        ]
        wild = rng.integers(1, num_items + 1, size=num_sessions)
        cur = np.where(rng.random(num_sessions) < noise, wild, pick)
    return np.stack(steps, axis=1).astype(np.int32)  # [N, length+1]


def ctr_labels(
    dense: np.ndarray,
    cats: dict[str, np.ndarray],
    vocab_sizes: list[int],
    *,
    label_seed: int = 1234,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Learnable CTR labels: sigmoid(dense weights + per-id effects).

    The latent weights derive ONLY from `label_seed` and the vocab
    config, so every batch (train or validation, any host) is labeled by
    the same ground-truth function — a model that learns drives AUC well
    above 0.5, unlike iid random labels which are UNLEARNABLE and pin
    AUC at 0.5 (the old dummy mode; kept via learnable=False switches).
    """
    lrng = np.random.default_rng(label_seed)
    w_dense = lrng.normal(size=dense.shape[1]) / np.sqrt(dense.shape[1])
    logit = dense @ w_dense
    for i, v in enumerate(vocab_sizes):
        # Cheap deterministic per-id effect: a hashed 3-level strength.
        a, b = lrng.integers(1, 2**31, size=2)
        ids = np.asarray(cats[f"cat_{i}"])
        eff = (((ids * a + b) % 997) % 3 - 1).astype(np.float32)
        logit = logit + 0.3 * eff.mean(axis=-1)
    p = 1.0 / (1.0 + np.exp(-logit))
    if rng is None:
        rng = np.random.default_rng(0)
    return (rng.random(len(p)) < p).astype(np.float32)


def criteo_like_batch(
    batch_size: int,
    *,
    num_dense: int = 13,
    vocab_sizes: list[int] | None = None,
    multi_hot_sizes: list[int] | None = None,
    seed: int = 0,
    learnable: bool = False,
) -> dict[str, np.ndarray]:
    """One Criteo-shaped batch: dense floats + per-feature multi-hot ids.

    `learnable=True` labels the batch with the deterministic CTR
    function from `ctr_labels` (AUC-convergence evidence); the default
    keeps iid random labels (pure-throughput benchmarking, where a
    learnable signal is irrelevant).
    """
    rng = np.random.default_rng(seed)
    if vocab_sizes is None:
        vocab_sizes = [1000] * 26
    if multi_hot_sizes is None:
        multi_hot_sizes = [1] * len(vocab_sizes)
    out: dict[str, np.ndarray] = {
        "dense": rng.normal(size=(batch_size, num_dense)).astype(np.float32),
    }
    for i, (v, m) in enumerate(zip(vocab_sizes, multi_hot_sizes)):
        out[f"cat_{i}"] = rng.integers(
            0, v, size=(batch_size, m), dtype=np.int64
        )
    if learnable:
        out["label"] = ctr_labels(
            out["dense"], out, list(vocab_sizes), rng=rng
        )
    else:
        out["label"] = rng.integers(0, 2, size=(batch_size,)).astype(
            np.float32
        )
    return out
