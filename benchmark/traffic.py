"""The one traffic generator: Criteo-shaped training batches from a mix's
parameters (`traffic/<name>.json`) and the run's seed.

A batch is what the port's ml_perf loader hands over: "dense" [B, 13]
float32, "cat_i" [B, valence_i] int64 ids below the feature's vocabulary,
"label" [B] float32 in {0, 1}. Batch i of a run is drawn from its own
generator (`derive(seed, "batch", i)`), so a batch does not depend on how
many others are drawn. The generator follows the port's
`data/synthetic.criteo_like_batch` (uniform ids, normal dense features,
iid labels), with the label rate taken from the mix. A mix with another
id distribution names a generator module of its own.

A mix's keys:
  valences     ids per example of each of the 26 features;
  ids          {"distribution": "uniform"};
  dense        {"distribution": "normal", "mean", "stddev"};
  labels       {"distribution": "bernoulli", "p"};
  pool_batches raw batches made at set-up and cycled by the loader.
"""

from __future__ import annotations

import numpy as np

from benchmark.spec import derive


def make_batch(config: dict, traffic: dict, seed: int,
               index: int) -> dict[str, np.ndarray]:
    """Batch `index` of a run with seed `seed`."""
    B = int(config["global_batch_size"])
    vocabs = config["vocab_sizes"]
    valences = traffic["valences"]
    if len(valences) != len(vocabs):
        raise ValueError(f"{len(valences)} valences for {len(vocabs)} "
                         "features")
    rng = np.random.default_rng(derive(seed, "batch", index))
    dense = traffic["dense"]
    out = {"dense": rng.normal(dense.get("mean", 0.0),
                               dense.get("stddev", 1.0),
                               size=(B, config["num_dense_features"]))
           .astype(np.float32)}
    if traffic["ids"]["distribution"] != "uniform":
        raise ValueError(f"unknown id distribution {traffic['ids']!r}")
    for i, (v, m) in enumerate(zip(vocabs, valences)):
        out[f"cat_{i}"] = rng.integers(0, v, size=(B, m), dtype=np.int64)
    labels = traffic["labels"]
    if labels["distribution"] != "bernoulli":
        raise ValueError(f"unknown label distribution {labels!r}")
    out["label"] = (rng.random(B) < labels["p"]).astype(np.float32)
    return out


def make_pool(config: dict, traffic: dict, seed: int) -> list[dict]:
    """The run's raw batches, in the order the loader cycles them."""
    return [make_batch(config, traffic, seed, i)
            for i in range(int(traffic["pool_batches"]))]


def large_features(config: dict) -> list[int]:
    """Features whose vocabulary goes to the stacked engine."""
    return [i for i, v in enumerate(config["vocab_sizes"])
            if v >= config["embedding_threshold"]]
