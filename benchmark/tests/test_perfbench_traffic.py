"""The traffic generator: seeded, shaped as the loader hands batches over,
ids inside each vocabulary."""

import json

import numpy as np
import pytest

from benchmark import traffic
from benchmark.spec import HERE

SEED = 2**31 + 977


def _small(mix_name, batch=256):
    config = json.loads(
        (HERE / "configs" / "dlrm-dcnv2-mlperf-packed4m.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{mix_name}.json").read_text())
    return dict(config, global_batch_size=batch), mix


@pytest.mark.parametrize("valences,per_example,large", [
    (None, 214, 172),
    ([1] * 26, 26, 9),
])
def test_batch_shapes_and_ranges(valences, per_example, large):
    config, mix = _small("multihot")
    if valences is not None:
        mix = dict(mix, valences=valences)
    b = traffic.make_batch(config, mix, SEED, 0)
    assert b["dense"].shape == (256, 13) and b["dense"].dtype == np.float32
    assert set(np.unique(b["label"])) <= {0.0, 1.0}
    ids = [b[f"cat_{i}"] for i in range(26)]
    assert sum(x.shape[1] for x in ids) == per_example
    assert sum(b[f"cat_{i}"].shape[1]
               for i in traffic.large_features(config)) == large
    for x, v in zip(ids, config["vocab_sizes"]):
        assert x.dtype == np.int64 and x.min() >= 0 and x.max() < v


def test_same_seed_same_batch_other_seed_other_batch():
    config, mix = _small("multihot")
    a = traffic.make_batch(config, mix, SEED, 3)
    b = traffic.make_batch(config, mix, SEED, 3)
    c = traffic.make_batch(config, mix, SEED + 1, 3)
    d = traffic.make_batch(config, mix, SEED, 4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["cat_20"], c["cat_20"])
    assert not np.array_equal(a["cat_20"], d["cat_20"])


def test_pool_cycles_distinct_batches():
    config, mix = _small("multihot", 64)
    pool = traffic.make_pool(config, mix, SEED)
    assert len(pool) == mix["pool_batches"]
    assert not np.array_equal(pool[0]["cat_0"], pool[1]["cat_0"])


def test_unknown_id_distribution_is_refused():
    config, mix = _small("multihot", 8)
    with pytest.raises(ValueError, match="id distribution"):
        traffic.make_batch(config, dict(mix, ids={"distribution": "zipf"}),
                           SEED, 0)
