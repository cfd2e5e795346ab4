"""Basic ranking: a two-embedding MLP rating regressor, as a walkthrough.

The port of examples/basic_ranking.py: embed the user id and the item
id, concatenate, MLP(256, 64, 1) to a rating, MSE loss, held-out RMSE.
The data is the synthetic MovieLens-like generator: ratings are
`2.75 + 2 * <u_f, i_f> + 0.1 * noise` from latent user and item factors,
so the task is learnable through the ids and its irreducible error is
the 0.1 rating noise, an absolute floor to read the RMSE against. The
held-out split shares the training split's latent factors (one universe,
fresh (user, item) draws). Adam(3e-3), where the reference trains with
Adagrad(0.1): on this task Adagrad stalls near the mean predictor (the
JAX example's note).

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.basic_ranking              # cuda:0
  python -m keras_rs_tpu_torch.examples.basic_ranking --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models.ranking_model import BasicRanking, mse_loss
from keras_rs_tpu_torch.training.train_state import DenseAdam
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

NOISE_FLOOR = 0.1  # the generator's rating-noise sigma


def main(device=None, epochs: int = 20, num_examples: int = 60_000,
         num_train: int = 50_000) -> float:
    """Trains and evaluates; returns the held-out RMSE."""
    device = resolve_device(device)
    data = synthetic.movielens_like(num_users=943, num_items=1682,
                                    num_examples=num_examples, seed=0)
    train = {k: v[:num_train] for k, v in data.items()}
    test = {k: v[num_train:] for k, v in data.items()}

    model = BasicRanking(943, 1682, embedding_dim=32,
                         hidden_units=(256, 64, 1), device=device,
                         generator=torch.Generator(device).manual_seed(42))
    trainer = Trainer(model, DenseAdam(model.parameters(), 3e-3), mse_loss)
    users = torch.from_numpy(test["user_id"]).to(device)
    items = torch.from_numpy(test["item_id"]).to(device)

    @torch.no_grad()
    def val_rmse(m):
        pred = m(users, items).cpu().numpy()
        return float(np.sqrt(np.mean((pred - test["rating"]) ** 2)))

    history = trainer.fit(lambda: synthetic.batches(train, 512, seed=1),
                          epochs=epochs, log_every=0,
                          validation_fn=val_rmse)
    for e, v in enumerate(history["val"]):
        if e % 4 == 0 or e == len(history["val"]) - 1:
            print(f"epoch {e}: held-out RMSE {v:.4f}")
    rmse = history["val"][-1]
    # The mean predictor: the ceiling a model must beat.
    base = float(np.std(test["rating"]))
    print(f"test RMSE: {rmse:.4f} (mean-predictor {base:.4f}, noise floor "
          f"~{NOISE_FLOOR})")
    return rmse


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    parser.add_argument("--epochs", type=int, default=20)
    args = parser.parse_args()
    main(args.device, args.epochs)
