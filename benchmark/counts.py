"""The yardstick's arithmetic: operations of the dense stack, bytes of
the row updates, and the H100's published peaks. It depends on the
configuration's shapes and the batch's ids alone, never on how the port
computes them, so a change to a kernel cannot move its own yardstick.
"""

from __future__ import annotations

import numpy as np

from benchmark.traffic import large_features

#: NVIDIA H100 SXM (data sheet, dense): HBM bytes/s and bf16 FLOP/s, both
#: at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

F32, BF16, INDEX = 4, 2, 4


def dense_macs_per_example(config: dict) -> int:
    """Multiply-adds of one example's forward pass through the bottom
    MLP, the DCNv2 layers (down and up projection) and the top MLP (the
    port's bench.py counts the same, at these widths)."""
    dim = config["embedding_dim"]
    concat = config["bottom_mlp"][-1] + dim * len(config["vocab_sizes"])
    macs, prev = 0, config["num_dense_features"]
    for u in config["bottom_mlp"]:
        macs += prev * u
        prev = u
    macs += config["num_dcn_layers"] * 2 * concat * config[
        "dcn_projection_dim"]
    prev = concat
    for u in config["top_mlp"]:
        macs += prev * u
        prev = u
    return macs


def dense_flops_per_step(config: dict) -> float:
    """Forward and backward of the dense stack: a product's backward is
    twice its forward, so 3 x 2 x MACs per example x batch."""
    return 6.0 * dense_macs_per_example(config) * config["global_batch_size"]


def unique_rows(config: dict, batch: dict) -> int:
    """Distinct rows of the large tables that `batch` touches: the rows a
    step's sparse update writes."""
    return int(sum(np.unique(np.asarray(batch[f"cat_{i}"])).size
                   for i in large_features(config)))


def update_bytes_per_row(config: dict) -> int:
    """Least bytes of one unique row's update, as kernel B1 (packed f32
    table + Adagrad) or B3 (bf16 row scatter) carries it:
      packed Adagrad: the [2, dim] f32 table + accumulator block read and
        written, the f32 gradient row read, the row's index read;
      bf16 split layout: the new bf16 row read and written into the table,
        the index read (the row-wise accumulator is written apart, by
        `index_copy_`)."""
    dim = config["embedding_dim"]
    if config["table_dtype"] == "float32" and config[
            "embedding_optimizer"] == "adagrad":
        return 2 * (2 * dim * F32) + dim * F32 + INDEX
    if config["table_dtype"] == "bfloat16":
        return 2 * dim * BF16 + INDEX
    raise ValueError("no update kernel counted for "
                     f"{config['table_dtype']} / "
                     f"{config['embedding_optimizer']}")


def update_floor_s(config: dict, rows: int) -> float:
    """The least time the H100 needs for the update of `rows` rows."""
    return rows * update_bytes_per_row(config) / HBM_BYTES_PER_S
