"""Deep & Cross Network (DCNv2): a walkthrough in three acts.

The port of examples/dcn.py:
  1. toy data whose target is a sum of explicit feature products, which
     one `FeatureCross` layer models (x0 * (x W) holds the xi * xj terms)
     and a plain MLP must approximate;
  2. the learned full-rank cross kernel read back: on the toy task its
     (i, j) couplings light up at the generating pairs;
  3. the RMSE mean +- std over `--runs` seeds of a full-rank cross, a
     low-rank cross (projection_dim 3) and an MLP alone, with parameter
     counts.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.dcn                  # cuda:0
  python -m keras_rs_tpu_torch.examples.dcn --device cpu --runs 3
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
    FeatureCross,
)
from keras_rs_tpu_torch.training.train_state import DenseAdam
from keras_rs_tpu_torch.training.trainer import Trainer
from keras_rs_tpu_torch.utils.device import resolve_device

# The generating cross structure: (i, j, coefficient) products.
TRUE_CROSSES = [(1, 2, 0.4), (3, 4, 0.7), (5, 0, 0.2)]
DIM = 6


def make_cross_data(n=8192, seed=0):
    """y = 0.1 x0 + sum of c * xi * xj over TRUE_CROSSES."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, DIM)).astype(np.float32)
    y = 0.1 * x[:, 0]
    for i, j, c in TRUE_CROSSES:
        y = y + c * x[:, i] * x[:, j]
    return x, y.astype(np.float32)


class CrossModel(nn.Module):
    """An optional FeatureCross followed by an MLP head."""

    def __init__(self, kind: str, generator, device):
        super().__init__()
        if kind == "cross_full":
            self.cross = FeatureCross(DIM, generator=generator, device=device)
        elif kind == "cross_lowrank":
            self.cross = FeatureCross(DIM, projection_dim=3,
                                      generator=generator, device=device)
        else:
            self.cross = None
        self.mlp = MLP(DIM, (32, 32, 1), generator=generator, device=device)

    def forward(self, x):
        if self.cross is not None:
            x = self.cross(x)
        return self.mlp(x)[..., 0]


class CrossLinear(nn.Module):
    """A full-rank FeatureCross with a linear readout, so the kernel must
    model the crosses itself."""

    def __init__(self, generator, device):
        super().__init__()
        self.cross = FeatureCross(DIM, generator=generator, device=device)
        self.w = nn.Parameter(0.1 * torch.randn(
            DIM, generator=generator, device=device))

    def forward(self, x):
        return self.cross(x) @ self.w


def mse(model, batch):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def _train(model, x, y, epochs, batch, order_seed=None):
    trainer = Trainer(model, DenseAdam(model.parameters(), 0.01), mse)

    def data():
        idx = (np.arange(len(x)) if order_seed is None
               else np.random.default_rng(order_seed).permutation(len(x)))
        for i in range(0, len(x), batch):
            j = idx[i:i + batch]
            yield x[j], y[j]

    trainer.fit(data, epochs=epochs, log_every=0)


def run_once(kind: str, seed: int, device) -> tuple[float, nn.Module]:
    x, y = make_cross_data(seed=0)
    model = CrossModel(kind, torch.Generator(device).manual_seed(seed),
                       device)
    _train(model, x, y, epochs=8, batch=512, order_seed=seed)
    xt, yt = make_cross_data(n=2048, seed=123)
    with torch.no_grad():
        pred = model(torch.from_numpy(xt).to(device)).cpu().numpy()
    return float(np.sqrt(np.mean((pred - yt) ** 2))), model


def inspect_cross_kernel(device) -> dict:
    """Act 2: the coefficient of xi * xj through the linear head,
    w_j W[i, j] + w_i W[j, i], for every pair."""
    x, y = make_cross_data(n=16384, seed=0)
    model = CrossLinear(torch.Generator(device).manual_seed(0), device)
    _train(model, x, y, epochs=80, batch=512)
    W = model.cross.kernel.detach().cpu().numpy()
    w = model.w.detach().cpu().numpy()
    coupling = np.abs(W * w[None, :] + (W * w[None, :]).T)
    true_pairs = {(i, j) for i, j, _ in TRUE_CROSSES}
    true_pairs |= {(j, i) for i, j in true_pairs}
    other = [coupling[i, j] for i in range(DIM) for j in range(i + 1, DIM)
             if (i, j) not in true_pairs]
    mx_other = float(np.max(other))
    print("  cross+linear probe - recovered product coefficients (true in "
          "parens; max spurious pair last):")
    found = {}
    for i, j, c in TRUE_CROSSES:
        mark = "OK" if coupling[i, j] > mx_other else "??"
        found[(i, j)] = float(coupling[i, j])
        print(f"    x{i}*x{j}: {coupling[i, j]:.3f} (true {c})  [{mark}]")
    print(f"    max non-generating pair: {mx_other:.3f}")
    return {"pairs": found, "max_other": mx_other}


def main(num_runs: int = 10, device=None) -> dict:
    """Prints and returns {arch: (rmse mean, rmse std, params)} and the
    probe's couplings."""
    device = resolve_device(device)
    results = {}
    for kind in ("cross_full", "cross_lowrank", "deep_only"):
        rmses, model = [], None
        for s in range(num_runs):
            rmse, model = run_once(kind, s, device)
            rmses.append(rmse)
        n_params = sum(p.numel() for p in model.parameters())
        results[kind] = (float(np.mean(rmses)), float(np.std(rmses)),
                         n_params)
        print(f"{kind:14s} RMSE {np.mean(rmses):.4f} +- {np.std(rmses):.4f}"
              f"  ({n_params:,} params)")
    results["probe"] = inspect_cross_kernel(device)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    args = parser.parse_args()
    main(args.runs, args.device)
