"""EmbedReduce: embedding lookup followed by a weighted combiner reduce.

Counterpart of keras_rs_tpu/layers/embedding/embed_reduce.py. Inputs are
a (B, L) id matrix plus an optional (B, L) weight matrix whose zeros mark
padding, or a `Ragged` batch (data/ragged.py) or a sparse COO id matrix
(data/sparse_utils.py), which are densified to that form with 0/1
weights, multiplied into any weights given. The table is an
`nn.Parameter` with a dense gradient (`F.embedding`'s backward), updated
by the dense optimizer.

`QuantizedEmbedReduce` is the int8 inference variant (ops/quant.py): its
int8 table and scales are registered buffers, so they move with `.to()`
and land in an exported artifact (serving.export_fn).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keras_rs_tpu_torch.core import initializers
from keras_rs_tpu_torch.core import regularizers as reg_lib
from keras_rs_tpu_torch.core.serialization import export
from keras_rs_tpu_torch.data.ragged import Ragged
from keras_rs_tpu_torch.data.sparse_utils import is_sparse, sparse_densify
from keras_rs_tpu_torch.ops import quant
from keras_rs_tpu_torch.utils.device import resolve_device

SUPPORTED_COMBINERS = ("mean", "sum", "sqrtn")
#: QuantizedEmbedReduce's row layouts (ops/quant.py).
LAYOUTS = ("rows", "packed", "fused")


def _divide_no_nan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    safe = torch.where(y == 0, torch.ones_like(y), y)
    return torch.where(y == 0, torch.zeros_like(x), x / safe)


def _check_combiner(combiner: str) -> None:
    if combiner not in SUPPORTED_COMBINERS:
        raise ValueError(
            f"Invalid `combiner`: '{combiner}', use one of "
            f"{', '.join(SUPPORTED_COMBINERS)}."
        )


def densify_inputs(inputs: Any, weights: Any, feature: str | None = None):
    """(ids, weights) with a Ragged batch densified to padded numpy ids
    and 0/1 weights, and a sparse id matrix to dense ids and a 0/1 mask
    (tensors on its device); given weights multiply into the 0/1 ones.
    Other inputs come back as they were given. The errors are the JAX
    package's (EmbedReduce's, or DistributedEmbedding's when `feature`
    names the feature)."""
    where = "" if feature is None else f"Feature {feature!r}: "
    if is_sparse(inputs):
        # Missing positions read row 0; the mask zeroes them and keeps
        # them out of the combiner divisors.
        inputs, mask = sparse_densify(inputs)
        if is_sparse(weights):
            weights = weights.to_dense()
        if weights is not None:
            mask = mask * torch.as_tensor(weights, dtype=torch.float32,
                                          device=mask.device)
        return inputs, mask
    if is_sparse(weights):
        raise ValueError(f"{where}Sparse weights require sparse ids.")
    if isinstance(inputs, Ragged):
        ids, mask = inputs.to_padded()
        if isinstance(weights, Ragged):
            if not np.array_equal(np.asarray(weights.row_lengths),
                                  np.asarray(inputs.row_lengths)):
                raise ValueError(
                    f"{where}Ragged weights row_lengths must equal the ids "
                    "row_lengths."
                )
            wv, _ = weights.to_padded(max_length=ids.shape[1])
            mask = mask * np.asarray(wv, np.float32)
        elif weights is not None:
            mask = mask * np.asarray(weights, np.float32)
        return ids, mask
    if isinstance(weights, Ragged):
        raise ValueError(
            f"{where}Ragged weights require Ragged ids (shapes must align)."
        )
    return inputs, weights


@export("keras_rs_tpu_torch.layers.EmbedReduce")
class EmbedReduce(nn.Module):
    """Embeds 1-D or 2-D integer inputs; reduces the list axis if present.

    Combiner semantics (as in the JAX package):
      * 1-D inputs: no reduction; "sum" still scales by weights, while
        "mean"/"sqrtn" ignore weights.
      * 2-D inputs: weighted sum over axis -2, divided by sum(weights)
        for "mean" or sqrt(sum(weights^2)) for "sqrtn".
    """

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        *,
        generator: torch.Generator | None = None,
        embeddings_initializer: Any = "random_uniform",
        embeddings_regularizer: Any = None,
        combiner: str = "mean",
        table: torch.Tensor | None = None,
        device: Any = None,
        name: str | None = None,
    ) -> None:
        """`table` [input_dim, output_dim], where given, becomes the
        embeddings as f32 on its own device (no copy when it is f32
        already); else they are drawn with `generator` on `device`.
        `embeddings_regularizer` adds its penalty of the table to
        core.regularizers.regularization_loss."""
        super().__init__()
        _check_combiner(combiner)
        if table is not None:
            if tuple(table.shape) != (input_dim, output_dim):
                raise ValueError(
                    f"`table` shape {tuple(table.shape)} does not match "
                    f"({input_dim}, {output_dim})."
                )
            values = torch.as_tensor(table).to(torch.float32)
        else:
            values = initializers.get(embeddings_initializer)(
                (input_dim, output_dim), torch.float32,
                resolve_device(device), generator,
            )
        self.embeddings = nn.Parameter(values)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.embeddings_regularizer = reg_lib.get(embeddings_regularizer)
        self._regularizers = (
            {"embeddings": self.embeddings_regularizer}
            if self.embeddings_regularizer is not None else {}
        )
        self.name = name or "embed_reduce"

    def get_config(self) -> dict[str, Any]:
        """The architecture (the weights come from a checkpoint)."""
        return {
            "input_dim": self.input_dim,
            "output_dim": self.output_dim,
            "combiner": self.combiner,
            "name": self.name,
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "EmbedReduce":
        """An architecture-only rebuild from `get_config` (the weights
        come from a checkpoint): a fresh table on `config["device"]`
        (default cuda:0), drawn with `config["generator"]` where given."""
        return cls(**config)

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    def forward(self, inputs: Any, weights: Any = None) -> torch.Tensor:
        """Activations of `inputs`: a tensor of ids (rank 1: one row per
        id; rank 2: reduced over the last axis), a `Ragged` batch or a
        sparse id matrix; `weights` of the ids' shape (Ragged with Ragged
        ids)."""
        inputs, weights = densify_inputs(inputs, weights)
        inputs = torch.as_tensor(inputs, device=self.device)
        if weights is not None:
            weights = torch.as_tensor(weights, device=self.device)
        if inputs.ndim < 1:
            raise ValueError("`inputs` must have rank >= 1.")
        x = self._lookup(inputs)
        if inputs.ndim == 1:
            if weights is not None and self.combiner == "sum":
                x = x * weights.to(x.dtype)[:, None]
            return x
        if weights is None:
            x = x.sum(dim=-2)
            if self.combiner == "sum":
                return x
            weights = torch.ones(inputs.shape, dtype=x.dtype,
                                 device=x.device)
        else:
            weights = weights.to(x.dtype)
            if weights.shape != inputs.shape:
                raise ValueError(
                    f"`weights` shape {tuple(weights.shape)} must match "
                    f"`inputs` shape {tuple(inputs.shape)}."
                )
            x = (x * weights[..., None]).sum(dim=-2)
        if self.combiner == "mean":
            return _divide_no_nan(x, weights.sum(dim=-1)[..., None])
        if self.combiner == "sqrtn":
            return _divide_no_nan(
                x, torch.sqrt(torch.square(weights).sum(dim=-1))[..., None]
            )
        return x

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the table by id, as the reference's `jnp.take` fetches
        them: a negative id counts from the end (-1 is the last row), and
        an id outside [-vocab, vocab) gives a row of NaN, on the CPU and
        on CUDA alike (no index error, no device-side assert)."""
        n = self.input_dim
        ids = torch.where(ids < 0, ids + n, ids)
        outside = (ids < 0) | (ids >= n)
        rows = F.embedding(torch.where(outside, 0, ids), self.embeddings)
        return torch.where(outside[..., None], torch.nan, rows)

    def quantize_int8(self, layout: str = "rows") -> "QuantizedEmbedReduce":
        """Int8 per-row-quantized inference copy (4x less memory)."""
        return QuantizedEmbedReduce.from_table(
            self.embeddings.detach(), combiner=self.combiner,
            name=self.name, layout=layout,
        )


@export("keras_rs_tpu_torch.layers.QuantizedEmbedReduce")
class QuantizedEmbedReduce(EmbedReduce):
    """`EmbedReduce` over an int8 per-row-quantized table (inference).

    Rows are int8 with a per-row f32 scale (ops/quant.py), 4x less memory
    than f32 at <= absmax/254 per element. Build with `from_table`,
    `EmbedReduce.quantize_int8()` or `DistributedEmbedding.freeze(
    quantize="int8")`. The combiner semantics are EmbedReduce's; the row
    fetch follows `layout`, whose values are bit-identical for in-range
    ids:
      * "rows": buffers `q` int8 [R, dim] and `scale` f32 [R, 1]; ids
        outside [-R, R) give NaN rows and -1 is the last row, as in
        EmbedReduce;
      * "packed": buffer `qp` int32 [ceil(R/4), dim] (4 rows per word
        row) and `scale` f32 [R];
      * "fused" (dim 128 only): buffer `qp` int32 [ceil(R/8), 384] (8
        rows and their scales per group row); `scale` is empty.
    "packed" and "fused" clip out-of-range ids as the JAX package does
    (ops/quant.py take_rows_int8_packed / take_rows_int8_fused).
    """

    def __init__(
        self,
        q: torch.Tensor,
        scale: torch.Tensor,
        *,
        combiner: str = "mean",
        name: str | None = None,
        layout: str = "rows",
    ) -> None:
        _check_combiner(combiner)
        if layout not in LAYOUTS:
            raise ValueError(
                f"Invalid `layout`: {layout!r} (use 'rows', 'packed' "
                "or 'fused')."
            )
        if q.dtype != torch.int8 or q.ndim != 2:
            raise ValueError(
                f"`q` must be int8 [vocab, dim], got {q.dtype} "
                f"{tuple(q.shape)}."
            )
        if layout == "fused" and q.shape[1] != 128:
            raise ValueError(
                "layout='fused' requires dim == 128 (one 128-word plane "
                f"per 4 rows); got dim {q.shape[1]}."
            )
        scale = scale.to(torch.float32)
        if tuple(scale.shape) != (q.shape[0], 1):
            raise ValueError(
                f"`scale` must be [vocab, 1], got {tuple(scale.shape)}."
            )
        if layout == "fused":
            qp, scale = quant.pack_rows_int8_fused(q, scale), None
        elif layout == "packed":
            qp, scale = quant.pack_rows_int8_groups(q), scale.reshape(-1)
        else:
            qp = None
        self._init(layout, int(q.shape[0]), int(q.shape[1]), combiner,
                   name, q=None if qp is not None else q, qp=qp,
                   scale=scale)

    def _init(self, layout, rows, dim, combiner, name, *, q=None, qp=None,
              scale=None) -> None:
        nn.Module.__init__(self)
        self.layout = layout
        self.input_dim = rows
        self.output_dim = dim
        self.combiner = combiner
        self.embeddings_regularizer = None
        self._regularizers = {}
        self.name = name or "quantized_embed_reduce"
        if q is not None:
            self.register_buffer("q", q)
        if qp is not None:
            self.register_buffer("qp", qp)
        if scale is None:  # fused: the scales live in qp
            scale = torch.zeros((0,), dtype=torch.float32,
                                device=qp.device)
        self.register_buffer("scale", scale)

    @classmethod
    def _from_packed(cls, qp: torch.Tensor, scale1d: torch.Tensor,
                     rows: int, *, combiner: str = "mean",
                     name: str | None = None) -> "QuantizedEmbedReduce":
        """Wraps an already group-packed table and its [R] scale (no
        repacking)."""
        self = cls.__new__(cls)
        self._init("packed", int(rows), int(qp.shape[1]), combiner, name,
                   qp=qp, scale=scale1d)
        return self

    @classmethod
    def _from_fused(cls, qp: torch.Tensor, rows: int, *,
                    combiner: str = "mean",
                    name: str | None = None) -> "QuantizedEmbedReduce":
        """Wraps an already fused-packed table (no repacking)."""
        self = cls.__new__(cls)
        self._init("fused", int(rows), 128, combiner, name, qp=qp)
        return self

    @classmethod
    def from_table(cls, table: torch.Tensor, *, combiner: str = "mean",
                   name: str | None = None,
                   layout: str = "rows") -> "QuantizedEmbedReduce":
        q, scale = quant.quantize_rows_int8(torch.as_tensor(table))
        return cls(q, scale, combiner=combiner, name=name, layout=layout)

    def get_config(self) -> dict[str, Any]:
        return {**super().get_config(), "layout": self.layout}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "QuantizedEmbedReduce":
        """An architecture-only rebuild: zero q and unit scales on
        `config["device"]` (default cuda:0), whose values a checkpoint
        restores."""
        config = dict(config)
        rows, dim = config.pop("input_dim"), config.pop("output_dim")
        device = resolve_device(config.pop("device", None))
        return cls(torch.zeros((rows, dim), dtype=torch.int8, device=device),
                   torch.ones((rows, 1), device=device), **config)

    @property
    def device(self) -> torch.device:
        return self.scale.device

    @property
    def embeddings(self) -> torch.Tensor:
        """Dequantized [vocab, dim] f32 table (materializes the whole
        table: for export and debugging, never on the serving path)."""
        if self.layout == "fused":
            q, scale = quant.unpack_rows_int8_fused(self.qp, self.input_dim)
            return quant.dequantize_rows(q, scale[:, None])
        if self.layout == "packed":
            q = quant.unpack_rows_int8_groups(self.qp, self.input_dim)
            return quant.dequantize_rows(q, self.scale[:, None])
        return quant.dequantize_rows(self.q, self.scale)

    def _lookup(self, ids: torch.Tensor) -> torch.Tensor:
        if self.layout == "fused":
            return quant.take_rows_int8_fused(self.qp, ids)
        if self.layout == "packed":
            return quant.take_rows_int8_packed(self.qp, self.scale, ids)
        n = self.input_dim
        ids = torch.where(ids < 0, ids + n, ids)
        outside = (ids < 0) | (ids >= n)
        safe = torch.where(outside, 0, ids)
        rows = self.q[safe].to(torch.float32) * self.scale[safe]
        return torch.where(outside[..., None], torch.nan, rows)
