"""The yardstick's arithmetic against hand counts."""

import numpy as np
import pytest

from benchmark import counts
from benchmark.spec import load_cell

CONFIGS = ["dlrm-packed.multihot", "dlrm-capacity.multihot"]


@pytest.mark.parametrize("workload", CONFIGS)
def test_dense_macs_hand_count(workload):
    config = load_cell(workload).config
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    concat = 128 + 26 * 128
    dcn = 3 * (concat * 512 + 512 * concat)
    top = concat * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1
    assert bottom + dcn + top == 16_030_464
    assert counts.dense_macs_per_example(config) == 16_030_464
    assert counts.dense_flops_per_step(config) == pytest.approx(
        6 * 16_030_464 * 16_384)
    assert counts.dense_flops_per_step(config) == pytest.approx(
        1.576e12, rel=1e-3)


def _tiny(table_dtype, optimizer):
    return {"vocab_sizes": [100, 5, 50], "embedding_threshold": 10,
            "embedding_dim": 128, "table_dtype": table_dtype,
            "embedding_optimizer": optimizer}


@pytest.mark.parametrize("table_dtype,optimizer,per_row", [
    ("float32", "adagrad", 2 * 1024 + 512 + 4),
    ("bfloat16", "rowwise_adagrad", 2 * 256 + 4),
])
def test_update_bytes_of_known_uniques(table_dtype, optimizer, per_row):
    config = _tiny(table_dtype, optimizer)
    batch = {"cat_0": np.array([[1, 1, 7], [7, 99, 3]]),
             "cat_1": np.array([[0], [4]]),  # small table: not counted
             "cat_2": np.array([[5, 5, 5], [6, 5, 49]])}
    rows = counts.unique_rows(config, batch)
    assert rows == 4 + 3
    assert counts.update_bytes_per_row(config) == per_row
    assert counts.update_floor_s(config, rows) == pytest.approx(
        7 * per_row / 3.35e12)


def test_update_bytes_refuses_uncounted_layouts():
    with pytest.raises(ValueError):
        counts.update_bytes_per_row(_tiny("float32", "adam"))
