"""Sequential retrieval with GRU4Rec, against a computable oracle.

The port of examples/sequential_retrieval.py: Markov watch sessions
(`synthetic.markov_sessions`: a noisy item-transition graph) -> an item
embedding and a GRU query tower trained with the in-batch softmax,
evaluated by next-item retrieval on held-out sessions. The generator is
first-order Markov, so the best order-1 predictor is known (rank the
successors of the last item), and the walkthrough prints three numbers:

    popularity baseline   <=   GRU4Rec   <=   order-1 oracle

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.sequential_retrieval       # cuda:0
  python -m keras_rs_tpu_torch.examples.sequential_retrieval --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.gru4rec import GRU4Rec, gru4rec_loss
from keras_rs_tpu_torch.training.train_state import DenseAdam
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

NUM_ITEMS = 500
BRANCHING = 12
NOISE = 0.2


def order1_oracle_recall(hist, target, trans_counts, k=10) -> float:
    """Recall@k of the top-k successors of the last item under the
    empirical transition counts of the training sessions."""
    topk = np.argsort(trans_counts, axis=1)[:, -k:]
    last = hist[:, -1]
    return float(np.mean([target[i] in topk[last[i]]
                          for i in range(len(last))]))


def main(device=None, epochs: int = 15) -> dict:
    """Trains and evaluates; returns the three recalls@10."""
    device = resolve_device(device)
    seq = synthetic.markov_sessions(
        num_items=NUM_ITEMS, num_sessions=10_240, length=10,
        branching=BRANCHING, noise=NOISE, seed=0)
    hist, target = seq[:, :-1], seq[:, -1]
    n_train = 8192

    trans = np.zeros((NUM_ITEMS + 1, NUM_ITEMS + 1), np.int32)
    dst = seq[:n_train, 1:].reshape(-1)
    np.add.at(trans, (seq[:n_train, :-1].reshape(-1), dst), 1)

    model = GRU4Rec(NUM_ITEMS, embedding_dim=64, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    trainer = Trainer(model, DenseAdam(model.parameters(), 0.01),
                      gru4rec_loss)

    def data():
        order = np.random.default_rng(4).permutation(n_train)
        for i in range(0, n_train, 256):
            j = order[i:i + 256]
            yield {"item_history": hist[j], "target_item": target[j]}

    trainer.fit(data, epochs=epochs, log_every=0, prefetch=2)

    with torch.no_grad():
        q = model.query_tower(torch.from_numpy(hist[n_train:]).to(device))
        top = model.make_retrieval(k=10)(q).cpu().numpy()
    held = target[n_train:]
    recall = float(np.mean([held[i] in top[i] for i in range(len(top))]))
    oracle = order1_oracle_recall(hist[n_train:], held, trans, k=10)
    pop = np.argsort(np.bincount(dst, minlength=NUM_ITEMS + 1))[-10:]
    pop_recall = float(np.mean(np.isin(held, pop)))
    captured = (recall - pop_recall) / max(oracle - pop_recall, 1e-9)
    print(f"recall@10: {recall:.3f}  (popularity {pop_recall:.3f}, order-1 "
          f"oracle {oracle:.3f} -> {captured:.0%} of the learnable signal "
          f"captured)")
    return {"recall": recall, "popularity": pop_recall, "oracle": oracle}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=15)
    args = parser.parse_args()
    main(args.device, args.epochs)
