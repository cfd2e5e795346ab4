"""Capacity auto-grow and input stats of the port's DistributedEmbedding
(ROADMAP C6) against the JAX layer, on the cases of
tests/test_round2_fixes.py (TestAutoGrow, TestRecordStats) and
tests/test_parity_features.py:89: at D = 1 in this process (the host
path) and at D = 8, the reference tests' own mesh, over eight gloo CPU
ranks (the device path, whose stats merge across ranks). Capacities and
stats are integers: equal. Activations with an all-ones table: exactly
the valence, as the reference requires.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.embedding import config as jconfig
from keras_rs_tpu.layers.embedding.distributed_embedding import (
    DistributedEmbedding as JaxEmbedding,
)
from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    DeviceStats,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)

B = 16
# tests/test_round2_fixes.py:104-110 and test_parity_features.py:40-60.
GROW = dict(name="t", vocab=100, dim=8, optimizer="sgd", combiner="sum",
            max_ids=4, max_unique=4)
REBUILD = dict(name="t", vocab=100, dim=8, optimizer="adagrad",
               combiner="mean", max_ids=2, max_unique=8)
FEATURE = dict(name="f", table="t", input_shape=(B, 4), output_shape=(B, 8))


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def skewed_ids():
    """Every entry on shard 7 of 8 (test_round2_fixes.py:150-153)."""
    ids = np.full((B, 4), 7, np.int64)
    ids[:, 1] = (np.arange(B) % 5) * 8 + 7
    return ids


def rebuild_ids():
    ids = np.full((B, 4), 7, np.int64)
    ids[:, 1] = np.arange(B) % 5
    return ids


def jax_layer(table, D, **kwargs):
    t = jconfig.TableConfig(
        table["name"], table["vocab"], table["dim"],
        optimizer=table["optimizer"], combiner=table["combiner"],
        placement="sharded", max_ids_per_partition=table["max_ids"],
        max_unique_ids_per_partition=table["max_unique"])
    fc = jconfig.FeatureConfig("f", t, (B, 4), (B, 8))
    return JaxEmbedding([fc], key=jax.random.key(0),
                        mesh=jmesh.create_mesh(jax.devices()[:D]), **kwargs)


def port_layer(table, **kwargs):
    return DistributedEmbedding(
        workers.feature_configs([table], [FEATURE], nest="list"),
        generator=torch.Generator().manual_seed(0), device="cpu", **kwargs)


def capacities(layer):
    return [(s.max_ids_per_partition, s.max_unique_ids_per_shard)
            for s in layer.stacks]


def capped(caps, D, seen=0):
    """The JAX layer's capacities at most what a batch can fill, where
    the port's growth stops (ROADMAP C4): a bucket one rank's B / D
    samples at the feature's valence 4 (or the `seen` ids of a bucket, if
    more), a shard D buckets, and U's one slot more."""
    most = max(B // D * 4, seen)
    return [(min(c, most), min(u, D * most + 1)) for c, u in caps]


def stats_list(stats):
    return {k: [v.max_ids_per_bucket, v.max_unique_per_shard, v.dropped_ids]
            for k, v in stats.items()}


def jax_preprocess(layer, ids, training):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pre = layer.preprocess({"f": ids}, training=training)
    return pre, [str(w.message) for w in caught]


# --- D = 1 (host path) --------------------------------------------------

def test_training_overflow_grows_and_drops_nothing_d1():
    j = jax_layer(GROW, 1, auto_grow=True)
    jax_preprocess(j, skewed_ids(), True)
    t = port_layer(GROW, auto_grow=True)
    assert capacities(t) == [(4, 4)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no drop warnings allowed
        pre = t.preprocess([skewed_ids()], training=True)
    assert capacities(t) == capped(capacities(j), 1)
    assert capacities(t)[0][0] > 4
    assert stats_list(t.input_stats) == stats_list(j.input_stats)
    assert t.input_stats[t.stacks[0].name].dropped_ids == 0
    t.set_embedding_tables({"t": np.ones((100, 8), np.float32)})
    with torch.no_grad():
        acts = t(pre)
    assert isinstance(acts, list)
    np.testing.assert_array_equal(acts[0].numpy(), 4.0)


def test_auto_grow_off_warns_and_drops_d1():
    j = jax_layer(GROW, 1, auto_grow=False)
    jax_preprocess(j, skewed_ids(), True)
    t = port_layer(GROW, auto_grow=False)
    with pytest.warns(UserWarning):
        t.preprocess({"f": skewed_ids()}, training=True)
    st = t.input_stats[t.stacks[0].name]
    assert st.dropped_ids > 0
    assert stats_list(t.input_stats) == stats_list(j.input_stats)
    assert capacities(t) == [(4, 4)]


def test_inference_never_grows_d1():
    t = port_layer(GROW, auto_grow=True)
    with pytest.warns(UserWarning):
        t.preprocess({"f": skewed_ids()}, training=False)
    assert capacities(t) == [(4, 4)] and t.input_stats == {}


def test_device_path_grows_like_the_host_path_d1():
    host = port_layer(GROW)
    host.preprocess({"f": skewed_ids()}, training=True)
    dev = port_layer(GROW)
    pre = dev.preprocess_on_device({"f": torch.from_numpy(skewed_ids())},
                                   training=True)
    assert capacities(dev) == capacities(host)
    assert stats_list(dev.input_stats) == stats_list(host.input_stats)
    dev.set_embedding_tables({"t": np.ones((100, 8), np.float32)})
    with torch.no_grad():
        np.testing.assert_array_equal(dev(pre)[0].numpy(), 4.0)


RECORDS = [(9, 6, 2), (5, 8, 1)]


def test_device_stats_fold_into_update_stats_d1():
    t = port_layer(GROW, auto_grow=False)
    name = t.stacks[0].name
    for rec in RECORDS:
        t.record_stats({name: DeviceStats(
            *(torch.tensor(x, dtype=torch.int32) for x in rec))})
    st = t.input_stats[name]
    assert (st.max_ids_per_bucket, st.max_unique_per_shard,
            st.dropped_ids) == (9, 8, 3)
    with pytest.warns(UserWarning):
        synced = t.update_stats()
    assert t.rebuild_capacities(synced=synced)
    assert t.stacks[0].max_ids_per_partition >= 9
    j = jax_layer(GROW, 1, auto_grow=False)
    from keras_rs_tpu.layers.embedding.device_preprocessing import (
        DeviceStats as JaxDeviceStats,
    )
    for rec in RECORDS:
        j.record_stats({j.stacks[0].name: JaxDeviceStats(
            *(np.int32(x) for x in rec))})
    with pytest.warns(UserWarning):
        j_synced = j.update_stats()
    assert j.rebuild_capacities(synced=j_synced)
    assert capacities(t) == capacities(j)


def test_update_stats_and_rebuild_capacities_d1():
    j = jax_layer(REBUILD, 1, auto_grow=False)
    jax_preprocess(j, rebuild_ids(), True)
    t = port_layer(REBUILD, auto_grow=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t.preprocess({"f": rebuild_ids()}, training=True)
    assert stats_list(t.input_stats) == stats_list(j.input_stats)
    old_c = t.stacks[0].max_ids_per_partition
    with pytest.warns(UserWarning, match="exceed capacities"):
        t.update_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert t.rebuild_capacities()
        j.rebuild_capacities()
    assert t.stacks[0].max_ids_per_partition > old_c
    assert capacities(t) == capped(capacities(j), 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pre = t.preprocess({"f": rebuild_ids()}, training=False)
    with torch.no_grad():
        assert torch.isfinite(t(pre)[0]).all()


# --- D = 8 (device path over eight ranks) -------------------------------

def test_training_overflow_grows_and_drops_nothing_d8(ranks):
    j = jax_layer(GROW, 8, auto_grow=True)
    _, j_warn = jax_preprocess(j, skewed_ids(), True)
    got = ranks(8).run("autogrow_case", tables=[GROW], features=[FEATURE],
                       inputs={"f": skewed_ids()}, auto_grow=True,
                       training=True, ones_table="t")
    initial = capacities(jax_layer(GROW, 8))
    assert initial == [(4, 32)]  # U = 4 per partition x 8 shards
    for r, out in enumerate(got):
        assert out["before"] == initial
        assert out["after"] == capped(capacities(j), 8), (r, out["after"])
        assert out["merged_stats"] == stats_list(j.input_stats)
        assert not any("capacity" in w for w in out["warnings"])
        np.testing.assert_array_equal(out["acts"][0], 4.0)
    assert list(j.input_stats.values())[0].dropped_ids == 0


def test_auto_grow_off_drops_d8(ranks):
    j = jax_layer(GROW, 8, auto_grow=False)
    jax_preprocess(j, skewed_ids(), True)
    got = ranks(8).run("autogrow_case", tables=[GROW], features=[FEATURE],
                       inputs={"f": skewed_ids()}, auto_grow=False,
                       training=True)
    for out in got:
        assert out["after"] == out["before"] == capacities(j)
        assert out["merged_stats"] == stats_list(j.input_stats)
        assert list(out["merged_stats"].values())[0][2] > 0


def test_inference_never_grows_d8(ranks):
    got = ranks(8).run("autogrow_case", tables=[GROW], features=[FEATURE],
                       inputs={"f": skewed_ids()}, auto_grow=True,
                       training=False)
    for out in got:
        assert out["after"] == out["before"] == [(4, 32)]
        assert out["local_stats"] == {}


def test_device_stats_fold_into_update_stats_d8(ranks):
    # Rank r records its own observations; update_stats merges them (max
    # of the watermarks, sum of the drops) into what one process folding
    # both records holds.
    records = [[RECORDS[0]], [RECORDS[1]]] + [[]] * 6
    got = ranks(8).run("record_stats_case", tables=[GROW],
                       features=[FEATURE], records=records)
    j = jax_layer(GROW, 8, auto_grow=False)
    from keras_rs_tpu.layers.embedding.device_preprocessing import (
        DeviceStats as JaxDeviceStats,
    )
    for rec in RECORDS:
        j.record_stats({j.stacks[0].name: JaxDeviceStats(
            *(np.int32(x) for x in rec))})
    with pytest.warns(UserWarning):
        j_synced = j.update_stats()
    j.rebuild_capacities(synced=j_synced)
    for r, out in enumerate(got):
        if r < 2:
            assert out["merged"] == [9, 8, 3]
            assert any("exceed capacities" in w for w in out["warnings"])
            assert out["changed"]
            assert [out["capacities"]] == capped(capacities(j), 8, seen=9)


def test_update_stats_and_rebuild_capacities_d8(ranks):
    j = jax_layer(REBUILD, 8, auto_grow=False)
    jax_preprocess(j, rebuild_ids(), True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j.rebuild_capacities()
    got = ranks(8).run("rebuild_case", tables=[REBUILD],
                       features=[FEATURE], inputs={"f": rebuild_ids()})
    for out in got:
        assert any("exceed capacities" in w for w in out["warnings"])
        assert out["changed"] and out["new"][0] > out["old_c"]
        assert [out["new"]] == capped(capacities(j), 8)
        assert out["dropped_after"] == [0]
        assert np.isfinite(out["acts"][0]).all()
