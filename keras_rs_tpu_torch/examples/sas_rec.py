"""SASRec: self-attentive sequential recommendation, a full walkthrough.

The port of examples/sas_rec.py, in four stages:

  1. DATA: sessions from `synthetic.markov_sessions`, a noisy item
     transition graph, so next-item prediction has intrinsic entropy and
     held-out recall@10 is bounded by ~(1 - noise) * 10 / branching, not
     1.0; histories of T = 20 with pad id 0;
  2. MODEL: `models.sasrec.SASRec`, a tied item embedding (the same
     table embeds the inputs and scores the candidates), learned
     positions and causal pre-norm transformer blocks. At T = 20 the
     attention takes its einsum path (the flash kernels start at T 64,
     layers/attention.py);
  3. OBJECTIVE: at every position the state scores the true next item
     above a sampled negative, BCE masked at padding (`sasrec_loss`);
  4. EVALUATION: next-item recall@10 and NDCG@10 on held-out sessions,
     with a popularity baseline and the task's ceiling; then users with
     short histories scored by left-padding them into the context.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.sas_rec                    # cuda:0
  python -m keras_rs_tpu_torch.examples.sas_rec --device cpu --epochs 20
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.sasrec import SASRec, sasrec_loss
from keras_rs_tpu_torch.training.train_state import DenseAdam
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

NUM_ITEMS = 500
BRANCHING = 12
NOISE = 0.2
T = 20  # the context length (the reference uses 200 for ML-1M)


def make_sessions(num_sessions: int, seed: int = 0):
    """Sequences [N, T + 1] -> (histories, positives: the item after
    each position, uniform negatives resampled away from the
    positive)."""
    seq = synthetic.markov_sessions(
        num_items=NUM_ITEMS, num_sessions=num_sessions, length=T,
        branching=BRANCHING, noise=NOISE, seed=seed)
    rng = np.random.default_rng(seed + 1)
    hist = seq[:, :T]
    pos = seq[:, 1:T + 1]
    neg = rng.integers(1, NUM_ITEMS + 1, size=pos.shape).astype(np.int32)
    neg = np.where(neg == pos, (pos % NUM_ITEMS) + 1, neg)
    return hist, pos, neg


def pad_left(hist: np.ndarray, to_length: int) -> np.ndarray:
    """Variable-length prefixes left-padded (pad id 0) to the context."""
    out = np.zeros((hist.shape[0], to_length), hist.dtype)
    out[:, to_length - hist.shape[1]:] = hist
    return out


@torch.no_grad()
def evaluate(model: SASRec, hist: np.ndarray, truth: np.ndarray,
             k: int = 10) -> tuple[float, float]:
    """(recall@k, NDCG@k) of the true next items."""
    device = model.item_embedding.embeddings.device
    user_repr = model(torch.from_numpy(hist).to(device))
    _, top = model.make_retrieval(k=k)(user_repr)
    top = top.cpu().numpy()
    hits = [np.nonzero(top[i] == truth[i])[0] for i in range(len(top))]
    recall = float(np.mean([len(h) > 0 for h in hits]))
    ndcg = float(np.mean([1.0 / np.log2(2 + h[0]) if len(h) else 0.0
                          for h in hits]))
    return recall, ndcg


def popularity_baseline(train_pos: np.ndarray, truth: np.ndarray,
                        k: int = 10) -> float:
    pop = np.argsort(np.bincount(train_pos.reshape(-1)))[-k:]
    return float(np.mean(np.isin(truth, pop)))


def main(device=None, epochs: int = 10, layers: int = 2, heads: int = 2,
         dim: int = 64, batch: int = 256, num_sessions: int = 6144,
         num_train: int = 5120) -> float:
    """Trains and evaluates; returns the held-out recall@10."""
    device = resolve_device(device)
    hist, pos, neg = make_sessions(num_sessions)

    model = SASRec(vocabulary_size=NUM_ITEMS, num_layers=layers,
                   num_heads=heads, hidden_dim=dim, max_sequence_length=32,
                   device=device,
                   generator=torch.Generator(device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SASRec: {layers} blocks, {heads} heads, dim {dim} "
          f"({n_params:,} params)")

    trainer = Trainer(model, DenseAdam(model.parameters(), 0.005),
                      sasrec_loss)

    def data():
        order = np.random.default_rng(2).permutation(num_train)
        for i in range(0, num_train, batch):
            j = order[i:i + batch]
            yield {"item_history": hist[j], "positive_sequence": pos[j],
                   "negative_sequence": neg[j]}

    t0 = time.time()
    h = trainer.fit(data, epochs=epochs, log_every=0)
    print(f"loss: {h['loss'][0]:.4f} -> {h['loss'][-1]:.4f} "
          f"({time.time() - t0:.0f}s, {epochs} epochs)")

    truth = pos[num_train:, -1]
    recall, ndcg = evaluate(model, hist[num_train:], truth)
    pop = popularity_baseline(pos[:num_train], truth)
    ceiling = (1 - NOISE) * 10 / BRANCHING
    print(f"held-out recall@10: {recall:.3f}  NDCG@10: {ndcg:.3f} "
          f"(popularity {pop:.3f}, task ceiling ~{ceiling:.2f})")

    # Users with short histories, left-padded into the fixed context
    # (pad id 0 is masked).
    short = pad_left(hist[num_train:num_train + 4, -5:], T)
    r5, _ = evaluate(model, short, truth[:4])
    print(f"5-item-prefix demo recall@10 (4 users): {r5:.2f}")
    return recall


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--batch", type=int, default=256)
    args = parser.parse_args()
    main(args.device, args.epochs, args.layers, args.heads, args.dim,
         args.batch)
