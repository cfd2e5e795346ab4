"""The exchange's yardstick on several cards: the least bytes rank 0
must send in one training step of a DLRM-DCNv2 configuration whose large
tables are sharded over `cards` ranks, and the link's rate. It depends on
the configuration's shapes and the batch alone, never on how the port
exchanges them.

A step's exchange is four collectives, each with a payload of
  ids          all-to-all      the rank's large-table ids (B / D x the
                               ids an example), 4 bytes each;
  activations  reduce-scatter  the large features' pooled rows of the
                               global batch, B x features x dim;
  cotangents   all-gather      the same shape;
  dense        all-reduce      every dense leaf and small table;
the last three at 2 bytes an element (bf16, the configuration's compute
dtype). Whatever the algorithm (ring, tree, direct or NVLink SHARP), a
rank must send at least (D - 1) / D of each payload: the part that the
other ranks need from it alone. The port sends f32 activations,
cotangents and gradients, so it reads at most half of this floor's
share, and no lawful change can read over 100%.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import reference as ref
from benchmark.traffic import large_features

#: NVLink 4 on an H100 SXM: 18 links of 25 GB/s each way, 450 GB/s out
#: of a card (data sheet).
NVLINK_BYTES_PER_S = 450e9
#: What every NCCL kernel's name holds; inside a step only the
#: exchange's collectives (parallel/collectives.py) launch them.
NCCL_KERNEL = "nccl"
ID, BF16 = 4, 2


def cards(config: dict) -> int:
    """The ranks the configuration's deployment shards over."""
    return int(config.get("cards", 1))


def payload_bytes(config: dict, batch: dict) -> dict[str, int]:
    """Each collective's payload in one step on rank 0 (module
    docstring), by the kind names of parallel/collectives.py."""
    D = cards(config)
    B = int(config["global_batch_size"])
    large = large_features(config)
    acts = B * len(large) * config["embedding_dim"] * BF16
    dense = sum(math.prod(s) for s in ref.dense_leaf_shapes(config).values())
    ids = sum(np.asarray(batch[f"cat_{i}"])[: B // D].size for i in large)
    return {"all-to-all": ids * ID, "reduce-scatter": acts,
            "all-gather": acts, "all-reduce": dense * BF16}


def floor_bytes(config: dict, batch: dict) -> float:
    """The least bytes rank 0 sends in the step of `batch`."""
    D = cards(config)
    return (D - 1) / D * sum(payload_bytes(config, batch).values())


def floor_s(config: dict, batch: dict) -> float:
    """The least time that takes at NVLink's rate."""
    return floor_bytes(config, batch) / NVLINK_BYTES_PER_S
