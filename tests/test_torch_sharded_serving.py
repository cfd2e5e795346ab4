"""The serving forms and the explicit layouts of the port's sharded
embedding at D > 1 (gloo CPU ranks, tests/torch_dist_workers.py), held
to the port at D = 1 and to the JAX package's layer on a mesh of the
first D virtual CPU devices; the cases of tests/test_serving_copy.py and
tests/test_shard_rotation.py at D > 1.

Bounds:
  * freeze() at D = 2 and 4 against a D = 1 freeze of the same logical
    tables: equal, every tensor and the forward (f32, "int8",
    "int8_packed", "int8_fused"); against the JAX freeze: the forward
    within 1e-6 (the same gathers and combiner sums);
  * serving_copy() at D = 2 and 4: its forward equals the training
    layer's;
    it holds no slot and shares no table storage;
  * shard_rotation=False, table_stacking="never" and explicit groups:
    the rank's rows equal the JAX global array's block on device r, the
    config round-trips to the same layout, and the JAX states load
    through convert.load_params into the same rows (a state of another
    layout is refused).
"""

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

B = 16
SERVE_TABLES = [
    dict(name="wide", vocab=1000, dim=128, optimizer="adagrad"),
    dict(name="narrow", vocab=333, dim=16, optimizer="adagrad",
         combiner="mean"),
]
SERVE_FEATURES = [
    dict(name="a", table="wide", input_shape=(B, 3), output_shape=(B, 128)),
    dict(name="b", table="narrow", input_shape=(B, 2),
         output_shape=(B, 16)),
    dict(name="c", table="wide", input_shape=(B, 1), output_shape=(B, 128)),
]
QUANTIZE = [None, "int8", "int8_packed", "int8_fused"]

TABLES = [
    dict(name="t0", vocab=101, dim=8),
    dict(name="t1", vocab=64, dim=8),
    dict(name="t2", vocab=77, dim=16),
]
FEATURES = [
    dict(name="f0", table="t0", input_shape=(B, 2), output_shape=(B, 8)),
    dict(name="f1", table="t1", input_shape=(B, 1), output_shape=(B, 8)),
    dict(name="f2", table="t2", input_shape=(B, 3), output_shape=(B, 16)),
]
LAYOUTS = {
    "no_rotation": dict(shard_rotation=False),
    "never": dict(table_stacking="never"),
    "explicit": dict(table_stacking=[["t1", "t0"]]),
    "explicit_no_rotation": dict(table_stacking=[["t0", "t1"]],
                                 shard_rotation=False),
}


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def _values(tables, seed=0):
    rng = np.random.default_rng(seed)
    return {t["name"]: rng.normal(size=(t["vocab"], t["dim"])).astype(
        np.float32) for t in tables}


def _inputs(tables, features, seed=1):
    rng = np.random.default_rng(seed)
    vocab = {t["name"]: t["vocab"] for t in tables}
    return {f["name"]: rng.integers(0, vocab[f["table"]], f["input_shape"])
            for f in features}


def _jax_layer(D, tables, features, **kwargs):
    by_name = {
        t["name"]: jconfig.TableConfig(
            name=t["name"], vocabulary_size=t["vocab"],
            embedding_dim=t["dim"], optimizer=t.get("optimizer", "sgd"),
            combiner=t.get("combiner", "sum"), placement="sharded",
            max_ids_per_partition=64, max_unique_ids_per_partition=64)
        for t in tables
    }
    fcs = {f["name"]: jconfig.FeatureConfig(
        name=f["name"], table=by_name[f["table"]],
        input_shape=tuple(f["input_shape"]),
        output_shape=tuple(f["output_shape"])) for f in features}
    return JaxEmbedding(fcs, mesh=jmesh.create_mesh(jax.devices()[:D]),
                        key=jax.random.key(0), **kwargs)


@pytest.mark.parametrize("D", [2, 4])
def test_freeze_at_d_ranks_equals_one_device_and_jax(ranks, D):
    logical = _values(SERVE_TABLES)
    inputs = _inputs(SERVE_TABLES, SERVE_FEATURES)
    one = workers.serving_case(0, 1, SERVE_TABLES, SERVE_FEATURES, logical,
                               inputs, QUANTIZE)
    jl = _jax_layer(D, SERVE_TABLES, SERVE_FEATURES)
    jl.set_embedding_tables(logical)
    for r, out in enumerate(ranks(D).run(
            "serving_case", tables=SERVE_TABLES, features=SERVE_FEATURES,
            logical=logical, inputs=inputs, quantize=QUANTIZE)):
        for q in QUANTIZE:
            got, want = out["frozen"][str(q)], one["frozen"][str(q)]
            assert sorted(got["state"]) == sorted(want["state"]), q
            for k in want["state"]:
                np.testing.assert_array_equal(got["state"][k],
                                              want["state"][k],
                                              err_msg=f"{q} {k} rank {r}")
            jacts = jl.freeze(quantize=q)(inputs)
            for k in want["acts"]:
                np.testing.assert_array_equal(got["acts"][k],
                                              want["acts"][k])
                np.testing.assert_allclose(got["acts"][k],
                                           np.asarray(jacts[k]), rtol=1e-6,
                                           atol=1e-6, err_msg=f"{q} {k}")


@pytest.mark.parametrize("D", [2, 4])
def test_serving_copy_at_d_ranks(ranks, D):
    logical = _values(SERVE_TABLES)
    inputs = _inputs(SERVE_TABLES, SERVE_FEATURES)
    outs = ranks(D).run("serving_case", tables=SERVE_TABLES,
                        features=SERVE_FEATURES, logical=logical,
                        inputs=inputs, quantize=[])
    for r, out in enumerate(outs):
        c = out["copy"]
        assert c["equal"], f"rank {r}"
        assert not any("slot" in b for b in c["buffers"]), c["buffers"]
        assert not c["shared"]
        assert set(c["optimizers"]) == {"sgd"}
        assert c["num_shards"] == D and c["rotation"] is True
        assert c["stacking"] == [["wide"], ["narrow"]]  # pinned
    # The two ranks hold different shards (no gather happened).
    assert not np.array_equal(outs[0]["copy"]["local"][0],
                              outs[1]["copy"]["local"][0])


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_place_rows_as_jax(ranks, layout, D):
    kwargs = LAYOUTS[layout]
    values = _values(TABLES, seed=3)
    jl = _jax_layer(D, TABLES, FEATURES, **kwargs)
    jl.set_embedding_tables(values)
    states = {}
    for s in jl.stacks:
        st = jl.state.value[s.name]
        states[s.name] = {
            "table": np.asarray(st["table"]), "step": np.asarray(st["step"]),
            "layout": [(t.name, t.local_offset, t.rotation)
                       for t in s.tables]}
    jconf = jl.get_config()
    outs = ranks(D).run("placement_case", tables=TABLES, features=FEATURES,
                        values=values, states=states, **kwargs)
    for r, out in enumerate(outs):
        assert out["stacks"] == [
            [(t.name, t.local_offset, t.rotation) for t in s.tables]
            for s in jl.stacks]
        assert out["rebuilt_stacks"] == out["stacks"]
        for k in ("table_stacking", "dtype", "shard_rotation"):
            assert out["config"][k] == jconf[k], k
        for i, s in enumerate(jl.stacks):
            R = s.rows_per_shard
            block = np.asarray(jl.state.value[s.name]["table"])[
                r * R : (r + 1) * R]
            np.testing.assert_array_equal(out["local"][i], block,
                                          err_msg=f"{s.name} rank {r}")
            np.testing.assert_array_equal(out["rebuilt_local"][i], block)
            np.testing.assert_array_equal(out["loaded"][i], block)


def test_load_params_refuses_another_layout(ranks):
    values = _values(TABLES, seed=3)
    jl = _jax_layer(2, TABLES, FEATURES, shard_rotation=False)
    jl.set_embedding_tables(values)
    states = {s.name: {
        "table": np.asarray(jl.state.value[s.name]["table"]),
        "step": np.asarray(jl.state.value[s.name]["step"]),
        "layout": [(t.name, t.local_offset, t.rotation) for t in s.tables]}
        for s in jl.stacks}
    for out in ranks(2).run("placement_case", tables=TABLES,
                            features=FEATURES, values=values,
                            states=states):
        assert "shard_rotation" in out["loaded"], out["loaded"]


def test_dtype_is_stored_and_checked():
    layer = workers.build_layer(1, TABLES, FEATURES, dtype=torch.float32)
    assert layer.get_config()["dtype"] == "float32"
    with pytest.raises(ValueError, match="float32"):
        workers.build_layer(1, TABLES, FEATURES, dtype="bfloat16")
    with pytest.raises(ValueError, match="stacking"):
        workers.build_layer(1, TABLES, FEATURES, table_stacking="sometimes")
