"""Sparse id inputs: a 2-D `torch.sparse_coo_tensor` of ids.

Counterpart of keras_rs_tpu/data/sparse_utils.py, where the sparse input
is a JAX BCOO array. A sparse id matrix is densified with 0 at the
missing positions, which therefore read row 0 of the table, and a 0/1
mask with 1 at the stored positions zeroes those rows and feeds the
combiner divisors: exactly the padded-ids + weights form the embedding
layers consume, so the adapter loses nothing.

Indices are expected unique per position: a duplicated index sums its ids
(and gives a mask of 2) in `to_dense`, as BCOO's `todense` does. A BCOO's
`indices` are [nnz, 2]; torch's are [2, nnz].
"""

from __future__ import annotations

from typing import Any

import torch


def is_sparse(x: Any) -> bool:
    """Whether `x` is a torch sparse COO tensor."""
    return isinstance(x, torch.Tensor) and x.layout == torch.sparse_coo


def sparse_densify(sp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse ids -> (dense ids with 0 fill, f32 0/1 mask), on the sparse
    tensor's device, with BCOO `todense`'s semantics."""
    ids = sp.to_dense()
    indices = sp.indices() if sp.is_coalesced() else sp._indices()
    ones = torch.ones(indices.shape[1], dtype=torch.float32,
                      device=sp.device)
    mask = torch.sparse_coo_tensor(indices, ones, sp.shape).to_dense()
    return ids, mask
