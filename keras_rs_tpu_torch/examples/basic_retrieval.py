"""Basic retrieval: a two-tower model and brute-force top-k, exported for
serving.

The port of examples/basic_retrieval.py: two embedding towers trained
with the in-batch sampled softmax, then a `BruteForceRetrieval` over
every candidate for inference. The data is
`synthetic.implicit_feedback`: stochastic, multimodal user preferences,
so held-out recall@10 stays well below 1.0 (its ceiling is the top-10
preference mass); a popularity baseline is printed beside it. Last, the
query tower and the top-k are fused into one function and exported as a
`torch.export` artifact (serving.py) that a serving process loads
without this code; the artifact reproduces the top-k.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.basic_retrieval            # cuda:0
  python -m keras_rs_tpu_torch.examples.basic_retrieval --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.two_tower import (
    TwoTower,
    in_batch_softmax_loss,
)
from keras_rs_tpu_torch.serving import (
    export_fn,
    import_fn,
    make_retrieval_service,
)
from keras_rs_tpu_torch.training.train_state import DenseAdagrad
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device


def loss_fn(model: TwoTower, batch: dict) -> torch.Tensor:
    return in_batch_softmax_loss(model, batch["user_id"], batch["item_id"])


def main(device=None, epochs: int = 20, num_events: int = 60_000) -> float:
    """Trains, evaluates and exports; returns the held-out recall@10."""
    device = resolve_device(device)
    num_users, num_items = 500, 1000
    data = synthetic.implicit_feedback(
        num_users=num_users, num_items=num_items, num_events=num_events,
        holdout_per_user=2, seed=0)
    model = TwoTower(num_users, num_items, 32, device=device,
                     generator=torch.Generator(device).manual_seed(0))
    trainer = Trainer(model, DenseAdagrad(model.parameters(), 0.2), loss_fn)
    train = {"user_id": data["user_id"], "item_id": data["item_id"]}
    trainer.fit(lambda: synthetic.batches(train, 512, seed=3),
                epochs=epochs, log_every=0)

    # Held-out events: was the user's next sampled item in the top 10?
    retrieval = model.make_retrieval(k=10)
    eval_u, eval_i = data["eval_user_id"], data["eval_item_id"]
    users = torch.from_numpy(eval_u).to(device)
    with torch.no_grad():
        _, top = retrieval(model.query_tower(users))
    top = top.cpu().numpy()
    recall_at_10 = float(np.mean([eval_i[j] in top[j]
                                  for j in range(len(eval_u))]))
    # Popularity: always the 10 most common training items.
    pop = np.argsort(np.bincount(data["item_id"], minlength=num_items))[-10:]
    pop_recall = float(np.mean(np.isin(eval_i, pop)))
    print(f"recall@10: {recall_at_10:.3f} (popularity baseline "
          f"{pop_recall:.3f})")

    # Deployment: the query tower and the top-k as one exported function.
    service = make_retrieval_service(model.query_tower, retrieval)
    with torch.no_grad():
        blob = export_fn(service, users[:8])
        _, served_ids = import_fn(blob)(users[:8])
        _, direct_ids = service(users[:8])
    if not torch.equal(served_ids, direct_ids):
        raise AssertionError("the exported artifact's top-k differs")
    print(f"serving export round-trip OK ({len(blob) / 1e3:.0f} KB artifact "
          "reproduces the top-k)")
    return recall_at_10


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=20)
    args = parser.parse_args()
    main(args.device, args.epochs)
