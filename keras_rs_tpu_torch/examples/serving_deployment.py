"""Serving deployment walkthrough: freeze, quantize, export, serving copy.

The port of examples/serving_deployment.py. A trained DistributedEmbedding
+ dense scorer is served in the four deployment shapes of the port:

  1. `freeze()`                 slot-free tables + `serving.aot_compile`
                                (a CUDA graph on the card): the request
                                costs device execution only.
  2. `freeze(quantize="int8")`  int8 per-row tables: ~4x less memory at
                                <= absmax/254 per element (ops/quant.py).
  3. `export_fn / import_fn`    a saved `torch.export` program, served
                                without the model code.
  4. `serving_copy()`           the stacked layer without optimizer
                                slots, served through preprocess +
                                forward.

Run from the repository root:
  python -m keras_rs_tpu_torch.examples.serving_deployment           # cuda:0
  python -m keras_rs_tpu_torch.examples.serving_deployment --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch import serving
from keras_rs_tpu_torch.layers.dense import MLP
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.training.train_state import (
    DenseAdagrad,
    make_train_step,
)
from keras_rs_tpu_torch.utils.device import resolve_device, to_device

B = 64
FEATURES = ("user_id", "item_history", "item_id")


class Scorer(nn.Module):
    """Embedding layer + MLP head over the concatenated activations."""

    def __init__(self, generator: torch.Generator, device) -> None:
        super().__init__()
        user_t = TableConfig(
            "users", 2048, 32, optimizer="adagrad", combiner="mean",
            placement="sharded", max_ids_per_partition=256,
            max_unique_ids_per_partition=256,
        )
        item_t = TableConfig(
            "items", 4096, 32, optimizer="adagrad", combiner="mean",
            placement="sharded", max_ids_per_partition=1024,
            max_unique_ids_per_partition=512,
        )
        self.embedding = DistributedEmbedding(
            {
                "user_id": FeatureConfig("user_id", user_t, (B, 1), (B, 32)),
                "item_history": FeatureConfig(
                    "item_history", item_t, (B, 8), (B, 32)
                ),
                "item_id": FeatureConfig("item_id", item_t, (B, 1), (B, 32)),
            },
            generator=generator, device=device,
        )
        self.head = MLP(96, [64, 1], generator=generator, device=device)

    def forward(self, pre: dict) -> torch.Tensor:
        return score(self.embedding(pre), self.head)


def score(acts: dict, head: nn.Module) -> torch.Tensor:
    return head(torch.cat([acts[k] for k in FEATURES], dim=-1))[:, 0]


def make_batch(rng: np.random.Generator) -> dict:
    return {
        "user_id": rng.integers(0, 2048, (B, 1)),
        "item_history": rng.integers(0, 4096, (B, 8)),
        "item_id": rng.integers(0, 4096, (B, 1)),
    }


def unique_bytes(module: nn.Module) -> int:
    """Bytes of the module's distinct parameters and buffers."""
    tensors = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    return sum(t.numel() * t.element_size() for t in tensors.values())


def main(device=None) -> dict:
    """Runs the four acts; returns their score deltas and sizes."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    model = Scorer(gen, device)

    # Brief training so the tables hold learned (non-initial) rows.
    def loss_fn(m, batch):
        return nn.functional.binary_cross_entropy_with_logits(
            m(batch["pre"]), batch["label"])

    step = make_train_step(model, loss_fn, DenseAdagrad(model.parameters(),
                                                        0.1))
    for _ in range(5):
        loss = step({
            "pre": model.embedding.preprocess(make_batch(rng)),
            "label": to_device((rng.random(B) > 0.5).astype(np.float32),
                               device),
        })
    print(f"trained 5 steps, loss {float(loss):.4f}")

    raw = make_batch(rng)
    with torch.no_grad():
        want = model(model.embedding.preprocess(raw))
    ids = {k: to_device(v, device) for k, v in raw.items()}
    out = {}

    # --- 1. freeze + AOT -------------------------------------------------
    frozen = model.embedding.freeze()
    compiled = serving.aot_compile(lambda x: score(frozen(x), model.head),
                                   ids)
    out["frozen_aot"] = float((compiled(ids) - want).abs().max())
    print(f"frozen+AOT max |score delta| vs training layer: "
          f"{out['frozen_aot']:.2e}")
    assert out["frozen_aot"] < 1e-4

    # --- 2. int8 quantized tables ---------------------------------------
    frozen_q = model.embedding.freeze(quantize="int8")
    with torch.no_grad():
        got_q = score(frozen_q(ids), model.head)
    out["int8"] = float((got_q - want).abs().max())
    out["f32_bytes"], out["int8_bytes"] = (unique_bytes(frozen),
                                           unique_bytes(frozen_q))
    print(f"int8 tables: {out['int8_bytes'] / 1e3:.0f} kB vs f32 "
          f"{out['f32_bytes'] / 1e3:.0f} kB "
          f"({out['f32_bytes'] / out['int8_bytes']:.1f}x smaller), max "
          f"|score delta| {out['int8']:.2e}")

    # --- 3. portable export ---------------------------------------------
    head = model.head  # the artifact holds what the closure reaches
    blob = serving.export_fn(lambda x: score(frozen_q(x), head), ids)
    served = serving.import_fn(blob)
    torch.testing.assert_close(served(ids), got_q, rtol=1e-5, atol=1e-6)
    out["artifact_bytes"] = len(blob)
    print(f"exported artifact: {len(blob) / 1e3:.0f} kB, round-trips "
          "without model code")

    # --- 4. slot-free stacked serving -----------------------------------
    copy = model.embedding.serving_copy()
    with torch.no_grad():
        got_s = score(copy(copy.preprocess(raw)), model.head)
    out["copy"] = float((got_s - want).abs().max())
    out["train_state_bytes"] = unique_bytes(model.embedding)
    out["copy_state_bytes"] = unique_bytes(copy)
    print(f"serving_copy: state {out['copy_state_bytes'] / 1e3:.0f} kB vs "
          f"training {out['train_state_bytes'] / 1e3:.0f} kB, max |score "
          f"delta| {out['copy']:.2e}")
    assert out["copy"] < 1e-4
    print("serving deployment walkthrough OK")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default cuda:0)")
    main(parser.parse_args().device)
