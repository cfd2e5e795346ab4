"""Transformer building blocks for SASRec-style sequence encoders
(counterpart of keras_rs_tpu/layers/attention.py).

Pre-norm residual blocks, learned position embeddings and causal
multi-head self-attention with two compute paths:

  - the einsum pair (QK^T, softmax, PV), which materializes the
    [B, H, T, T] probabilities;
  - fused attention (ops/flash_attention.py): kernels B5-B7 on a CUDA
    tensor, their plain versions on a CPU tensor.

`use_flash="auto"` takes the kernels for a CUDA tensor with
T >= FLASH_MIN_T and the einsum path otherwise; `use_flash=True` always
takes the fused function. Weights keep the JAX package's [in, out]
layout (y = x @ w), so they move between the packages without a
transpose.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.layers.dense import Dense
from keras_rs_tpu_torch.ops import flash_attention as fa
from keras_rs_tpu_torch.utils.device import resolve_device


class Embedding(nn.Module):
    """Plain [vocab, dim] lookup; `attend(x)` scores x against the table
    (the tied, "reversible" projection SASRec uses). Glorot-uniform, the
    initializer SASRec gives it (the JAX layer's default, random_normal,
    has no caller)."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        self.embeddings = nn.Parameter(
            initializers.GlorotUniform()(
                (input_dim, output_dim), torch.float32,
                resolve_device(device), generator,
            )
        )
        self.input_dim = input_dim
        self.output_dim = output_dim

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # F.embedding, not self.embeddings[ids]: its backward reduces the
        # duplicated ids of a batch with a sort and a segment sum, where
        # the indexing backward accumulates them one by one.
        return F.embedding(ids, self.embeddings)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.embeddings.T)


class PositionEmbedding(nn.Module):
    """Learned position embeddings (glorot-uniform [max_length, dim]);
    returns the first T rows for a [..., T, dim] input."""

    def __init__(
        self,
        max_length: int,
        dim: int,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        self.embeddings = nn.Parameter(
            initializers.GlorotUniform()(
                (max_length, dim), torch.float32, resolve_device(device),
                generator,
            )
        )
        self.max_length = max_length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embeddings[: x.shape[-2]]


class LayerNorm(nn.Module):
    """(x - mean) * rsqrt(var + eps) * scale + offset, biased variance."""

    def __init__(self, dim: int, *, epsilon: float = 1e-6,
                 device: Any = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.offset = nn.Parameter(torch.zeros(dim, device=device))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.scale + self.offset


#: Shortest sequence for which "auto" takes the kernels: the shortest
#: length timed at the SASRec widths (batch 128, hidden 50, one head, f32)
#: by kernels/flash_crossover.py, where the kernels beat this einsum path
#: forward + backward on an H100 on the mean of four runs. Both paths are
#: launch-bound at these lengths, so a single run can swap them (PERF.md
#: section 7).
FLASH_MIN_T = 64


class MultiHeadSelfAttention(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        *,
        generator: torch.Generator | None = None,
        use_flash: bool | str = "auto",
        device: Any = None,
    ) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        device = resolve_device(device)
        init = initializers.GlorotUniform()

        def weight():
            return nn.Parameter(
                init((dim, dim), torch.float32, device, generator)
            )

        self.wq, self.wk, self.wv, self.wo = (
            weight(), weight(), weight(), weight()
        )
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_flash = use_flash

    def _flash_enabled(self, x: torch.Tensor) -> bool:
        if self.use_flash == "auto":
            return x.is_cuda and x.shape[1] >= FLASH_MIN_T
        return bool(self.use_flash)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: torch.Tensor | None = None,
        causal: bool = True,
    ) -> torch.Tensor:
        """x: [B, T, D]; padding_mask: [B, T], nonzero for real keys."""
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim
        q, k, v = (torch.matmul(x, w).reshape(B, T, H, hd)
                   for w in (self.wq, self.wk, self.wv))

        if self._flash_enabled(x):
            out = fa.flash_attention(q, k, v, causal=causal,
                                     key_mask=padding_mask)
            return torch.matmul(out.reshape(B, T, D), self.wo)

        logits = torch.einsum(
            "bqhd,bkhd->bhqk", q.float(), k.float()
        ) / math.sqrt(hd)
        neg = torch.full((), -1e9, dtype=logits.dtype, device=x.device)
        if causal:
            visible = torch.ones((T, T), dtype=torch.bool,
                                 device=x.device).tril()
            logits = torch.where(visible, logits, neg)
        if padding_mask is not None:
            logits = torch.where(padding_mask[:, None, None, :] != 0,
                                 logits, neg)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        return torch.matmul(out, self.wo)


class TransformerBlock(nn.Module):
    """Pre-norm causal decoder block: MHA + MLP with residuals."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_dim: int,
        *,
        generator: torch.Generator | None = None,
        device: Any = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.attention = MultiHeadSelfAttention(
            dim, num_heads, generator=generator, device=device,
        )
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp_in = Dense(dim, mlp_dim, generator=generator,
                            activation=torch.relu, device=device)
        self.mlp_out = Dense(mlp_dim, dim, generator=generator,
                             device=device)

    def forward(self, x: torch.Tensor,
                padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), padding_mask=padding_mask,
                               causal=True)
        return x + self.mlp_out(self.mlp_in(self.norm2(x)))
