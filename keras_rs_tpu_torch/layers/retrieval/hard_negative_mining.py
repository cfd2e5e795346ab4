"""Hard negative mining (counterpart of
keras_rs_tpu/layers/retrieval/hard_negative_mining.py).

Keeps each row's positive and its `num_hard_negatives` highest-scoring
negatives: the positive's logit is boosted by a large constant so a
top-k keeps it without an explicit mask, and logits and labels are
gathered at the top-k positions. The top-k is ops/topk.py's, in
`lax.top_k`'s order (equal values lowest index first), so the columns
come out in the reference's order.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.ops.topk import top_k

# Large-but-safe boost; max float32 / 100 like the reference.
MAX_FLOAT = float(np.finfo(np.float32).max / 100.0)


@export("keras_rs_tpu_torch.layers.HardNegativeMining")
class HardNegativeMining(nn.Module):
    def __init__(self, num_hard_negatives: int, name: str | None = None):
        super().__init__()
        self.num_hard_negatives = num_hard_negatives
        self.name = name or "hard_negative_mining"

    def forward(self, logits: torch.Tensor,
                labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, labels) restricted to the positive + the hardest
        negatives of each row: (..., N) -> (..., min(k + 1, N))."""
        num_sampled = min(self.num_hard_negatives + 1, logits.shape[-1])
        _, indices = top_k((logits + labels * MAX_FLOAT).detach(),
                           num_sampled)
        return (logits.gather(-1, indices), labels.gather(-1, indices))

    def get_config(self) -> dict[str, Any]:
        return {
            "num_hard_negatives": self.num_hard_negatives,
            "name": self.name,
        }
