"""Accidental-hit removal for in-batch negatives (counterpart of
keras_rs_tpu/layers/retrieval/remove_accidental_hits.py).

A negative whose candidate id equals its row's positive candidate id
gets a huge negative logit, so the softmax ignores it. The positive is
the first maximum of each label row (`torch.argmax` returns the first
maximum, as `jnp.argmax` does).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn
from keras_rs_tpu_torch.core.serialization import export

SMALLEST_FLOAT = float(np.finfo(np.float32).min / 100.0)


@export("keras_rs_tpu_torch.layers.RemoveAccidentalHits")
class RemoveAccidentalHits(nn.Module):
    def __init__(self, name: str | None = None):
        super().__init__()
        self.name = name or "remove_accidental_hits"

    def forward(self, logits: torch.Tensor, labels: torch.Tensor,
                candidate_ids: torch.Tensor) -> torch.Tensor:
        if labels.shape != logits.shape:
            raise ValueError(
                "`labels` and `logits` should have the same shape. Received: "
                f"`labels.shape` = {tuple(labels.shape)}, "
                f"`logits.shape` = {tuple(logits.shape)}."
            )
        if candidate_ids.shape != labels.shape[-candidate_ids.ndim:]:
            raise ValueError(
                "`candidate_ids` should match the last dimensions of "
                "`labels`. Received: `candidate_ids.shape` = "
                f"{tuple(candidate_ids.shape)}, `labels.shape` = "
                f"{tuple(labels.shape)}."
            )
        candidate_ids = candidate_ids.expand(labels.shape)
        positive_idx = torch.argmax(labels, dim=-1, keepdim=True)
        positive_candidate_ids = candidate_ids.gather(-1, positive_idx)
        duplicate = (positive_candidate_ids == candidate_ids).to(labels.dtype)
        return logits + (duplicate - labels) * SMALLEST_FLOAT

    def get_config(self) -> dict[str, Any]:
        return {"name": self.name}
