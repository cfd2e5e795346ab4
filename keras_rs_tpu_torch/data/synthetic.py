"""Synthetic data (numpy copies of keras_rs_tpu/data/synthetic.py's
`criteo_like_batch` and `markov_sessions`, so the card needs no JAX; the
same seed gives the same arrays in both packages)."""

from __future__ import annotations

import numpy as np


def criteo_like_batch(
    batch_size: int,
    *,
    num_dense: int = 13,
    vocab_sizes: list[int] | None = None,
    multi_hot_sizes: list[int] | None = None,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """One Criteo-shaped batch: "dense" [B, num_dense] f32 normal,
    "cat_i" [B, multi_hot_i] uniform ids in [0, vocab_i), and iid random
    0/1 "label" [B] f32."""
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
    out["label"] = rng.integers(0, 2, size=(batch_size,)).astype(np.float32)
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
    padding): [num_sessions, length + 1] int32.

    Each item has `branching` plausible successors (uniform among them),
    and with probability `noise` the next item is uniform over the whole
    catalog. Slice [:, :-1] as history and [:, 1:] as targets.
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
    return np.stack(steps, axis=1).astype(np.int32)
