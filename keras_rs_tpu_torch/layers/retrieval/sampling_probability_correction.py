"""Sampling probability correction, logQ (counterpart of
keras_rs_tpu/layers/retrieval/sampling_probability_correction.py):
logits - log(clip(p, epsilon, 1))."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from keras_rs_tpu_torch.core.serialization import export


@export("keras_rs_tpu_torch.layers.SamplingProbabilityCorrection")
class SamplingProbabilityCorrection(nn.Module):
    def __init__(self, epsilon: float = 1e-6, name: str | None = None):
        super().__init__()
        self.epsilon = epsilon
        self.name = name or "sampling_probability_correction"

    def forward(self, logits: torch.Tensor,
                candidate_sampling_probability: torch.Tensor) -> torch.Tensor:
        return logits - torch.log(
            torch.clamp(candidate_sampling_probability, self.epsilon, 1.0)
        )

    def get_config(self) -> dict[str, Any]:
        return {"epsilon": self.epsilon, "name": self.name}
