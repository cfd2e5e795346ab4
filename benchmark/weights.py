"""The benchmark's own weights, drawn from the run's seed.

The benchmark makes the initial weights and hands the same to the port
(which then trains them) and to the reference (which recomputes them), so
the reference takes nothing the port made. Each dense leaf and each block
of BLOCK_ROWS rows of a large table is drawn by its own generator on the
device (`derive(seed, "weights", name[, block])`), in one call, so any
row can be drawn again later without the rest of the table.

Kinds, as the port's default initializers draw them: kernels
glorot-uniform, biases zero, small tables uniform in [-0.05, 0.05], large
tables uniform with variance 1 / embedding_dim. A bf16 table stores the
draw rounded to nearest (`storage_round`), as the port's
`set_embedding_tables` does.
"""

from __future__ import annotations

import math

import torch

from benchmark.spec import derive

BLOCK_ROWS = 1 << 20


def _uniform(shape, limit: float, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return out.mul_(2.0 * limit).sub_(limit)


def dense_leaf(seed: int, name: str, shape, device) -> torch.Tensor:
    """The initial value of the dense parameter `name` (the port's
    parameter name)."""
    if name.endswith("bias"):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if name.startswith("small_embeddings."):
        return _uniform(shape, 0.05, derive(seed, "weights", name), device)
    fan_in, fan_out = shape
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)),
                    derive(seed, "weights", name), device)


def storage_round(config: dict, values: torch.Tensor) -> torch.Tensor:
    """f32 values as the configuration's table dtype stores them."""
    if config["table_dtype"] == "bfloat16":
        return values.to(torch.bfloat16).float()
    if config["table_dtype"] != "float32":
        raise ValueError(f"table_dtype {config['table_dtype']!r}")
    return values


def table_block(config: dict, seed: int, table: str, vocab: int,
                block: int, device) -> torch.Tensor:
    """Rows [block * BLOCK_ROWS, ...) of large table `table`, f32, as
    stored (`storage_round`)."""
    dim = config["embedding_dim"]
    lo = block * BLOCK_ROWS
    n = min(BLOCK_ROWS, vocab - lo)
    values = _uniform((n, dim), math.sqrt(3.0 / dim),
                      derive(seed, "weights", table, block), device)
    return storage_round(config, values)


def table_rows(config: dict, seed: int, table: str, vocab: int,
               ids: torch.Tensor) -> torch.Tensor:
    """The initial rows of sorted, distinct `ids` of large table `table`
    ([len(ids), dim] f32 on the ids' device), block by block."""
    out = torch.empty((ids.numel(), config["embedding_dim"]),
                      dtype=torch.float32, device=ids.device)
    for block, lo, hi in blocks_of(ids):
        values = table_block(config, seed, table, vocab, block, ids.device)
        out[lo:hi] = values[ids[lo:hi] - block * BLOCK_ROWS]
    return out


def blocks_of(ids: torch.Tensor):
    """(block, lo, hi): the positions [lo, hi) of sorted `ids` that fall in
    each block that holds any."""
    if ids.numel() == 0:
        return
    last = int(ids[-1]) // BLOCK_ROWS
    edges = torch.arange(last + 2, device=ids.device) * BLOCK_ROWS
    bounds = torch.searchsorted(ids, edges).tolist()
    for block in range(last + 1):
        if bounds[block + 1] > bounds[block]:
            yield block, bounds[block], bounds[block + 1]
