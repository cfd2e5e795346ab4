"""The port's sharded embedding at D > 1 (one gloo CPU process per
shard, tests/torch_dist_workers.py) against the JAX package's layer on a
mesh of the first D of the 8 virtual CPU devices, from the same numpy
inputs and logical tables.

Bounds:
  * integers of the COO transform (send rows, received buffers, uniques,
    entry -> unique maps) and the merged stats: bit for bit; gains
    within 1 f32 ulp (mean combiners divide by sums taken in another
    order);
  * f32 activations, losses and post-step tables: 1e-6 absolute + 1e-5
    relative (the same formulas; the segment sums and the reduce-scatter
    add in another order);
  * comm_dtype="bfloat16": within tests/test_comm_dtype.py's bounds of
    the f32 exchange (activations rtol 2e-2 / atol 1e-2, tables rtol
    2e-2 / atol 2e-4, loss 1e-2 relative), and of the JAX layer with the
    same exchange dtype.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch_dist_workers as workers
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.layers.embedding import config as jconfig
from keras_rs_tpu.layers.embedding import preprocessing as jpre
from keras_rs_tpu.layers.embedding import stacking as jstacking
from keras_rs_tpu.layers.embedding.distributed_embedding import (
    DistributedEmbedding as JaxEmbedding,
)
from keras_rs_tpu.parallel import mesh as jmesh

B = 16
TABLES = [
    dict(name="big", vocab=4096, dim=16, optimizer="adagrad",
         combiner="mean", max_ids=64, max_unique=64),
    dict(name="small", vocab=512, dim=8, optimizer="adagrad",
         combiner="sum", max_ids=64, max_unique=64),
    dict(name="rows", vocab=300, dim=128, optimizer="adagrad",
         combiner="sum", max_ids=64, max_unique=64),
]
FEATURES = [
    dict(name="a", table="big", input_shape=(B, 3), output_shape=(B, 16)),
    dict(name="b", table="small", input_shape=(B, 2), output_shape=(B, 8)),
    dict(name="c", table="rows", input_shape=(B, 4), output_shape=(B, 128)),
    dict(name="d", table="rows", input_shape=(B, 1), output_shape=(B, 128)),
]


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def jax_configs(tables, features, nest="dict"):
    by_name = {
        t["name"]: jconfig.TableConfig(
            name=t["name"], vocabulary_size=t["vocab"],
            embedding_dim=t["dim"], optimizer=t.get("optimizer", "sgd"),
            combiner=t.get("combiner", "sum"),
            placement=t.get("placement", "sharded"),
            dtype=t.get("dtype", "float32"),
            max_ids_per_partition=t.get("max_ids", 64),
            max_unique_ids_per_partition=t.get("max_unique", 64))
        for t in tables
    }
    fcs = [jconfig.FeatureConfig(
        name=f["name"], table=by_name[f["table"]],
        input_shape=tuple(f["input_shape"]),
        output_shape=tuple(f["output_shape"])) for f in features]
    return fcs if nest == "list" else {fc.name: fc for fc in fcs}


def jax_layer(D, tables=TABLES, features=FEATURES, seed=0, **kwargs):
    return JaxEmbedding(jax_configs(tables, features),
                        key=jax.random.key(seed),
                        mesh=jmesh.create_mesh(jax.devices()[:D]), **kwargs)


def inputs_of(features, seed=0, vocab=None):
    rng = np.random.default_rng(seed)
    vocab = vocab or {t["name"]: t["vocab"] for t in TABLES}
    return {f["name"]: rng.integers(0, vocab[f["table"]],
                                    f["input_shape"]).astype(np.int64)
            for f in features}


def weights_of(features, seed=1):
    rng = np.random.default_rng(seed)
    return {f["name"]: (rng.random(f["input_shape"]) * 2).astype(np.float32)
            * (rng.random(f["input_shape"]) > 0.2)
            for f in features}


def rows(a, rank, D):
    n = a.shape[0] // D
    return np.asarray(a)[rank * n : (rank + 1) * n]


def close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_rank_coo_equals_jax_global_row_and_column(ranks, D, weighted):
    inputs = inputs_of(FEATURES, seed=D)
    weights = weights_of(FEATURES) if weighted else None
    stacks = jstacking.build_stacks(
        list(jax_configs(TABLES, FEATURES).values()), D)
    got = ranks(D).run("coo_case", tables=TABLES, features=FEATURES,
                       inputs=inputs, weights=weights)
    for stack in stacks:
        coo, stats = jpre.preprocess_stack(
            stack, {f.name: inputs[f.name] for f in stack.features},
            None if weights is None else {f.name: weights[f.name]
                                          for f in stack.features},
            backend="numpy")
        merged = [0, 0, 0]
        for r in range(D):
            mine = got[r][stack.name]
            for k in ("send_slots", "send_segs"):
                np.testing.assert_array_equal(
                    mine[k][0], getattr(coo, k)[r], err_msg=f"{k} r{r}")
            np.testing.assert_array_equal(mine["recv_slots"],
                                          coo.send_slots[:, r])
            np.testing.assert_array_equal(mine["recv_segs"],
                                          coo.send_segs[:, r])
            np.testing.assert_array_equal(mine["unique_slots"][0],
                                          coo.unique_slots[r])
            np.testing.assert_array_equal(mine["entry_unique"][0],
                                          coo.entry_unique[r])
            for k, want in (("send_gains", coo.send_gains[r]),
                            ("recv_gains", coo.send_gains[:, r])):
                g = mine[k][0] if k == "send_gains" else mine[k]
                np.testing.assert_array_max_ulp(g, want, maxulp=1)
            close(mine["divisors"][0], coo.divisors[r], rtol=2e-7, atol=0)
            ids, uniq, dropped = mine["stats"]
            merged = [max(merged[0], ids), max(merged[1], uniq),
                      merged[2] + dropped]
        assert merged == [stats.max_ids_per_bucket,
                          stats.max_unique_per_shard, stats.dropped_ids]


def _jax_train(layer, batch, steps):
    opt = optax.sgd(0.1)
    state = jax_training.create_train_state(layer, opt)

    def loss_fn(lyr, b):
        return sum((v.astype(np.float32) ** 2).mean()
                   for v in lyr(b).values())

    step = jax_training.make_train_step(loss_fn, opt, donate=False)
    pre = layer.preprocess(batch)
    losses = []
    for _ in range(steps):
        state, loss = step(state, pre)
        losses.append(float(loss))
    return losses, state.model


@pytest.mark.parametrize("D", [2, 4])
def test_activations_and_training_steps_match_jax(ranks, D):
    inputs = inputs_of(FEATURES, seed=10 + D)
    jl = jax_layer(D)
    logical = {k: np.asarray(v)
               for k, v in jl.get_embedding_tables().items()}
    j_acts = {k: np.asarray(v) for k, v in jl(jl.preprocess(inputs)).items()}
    j_losses, j_after = _jax_train(jl, inputs, steps=2)
    got = ranks(D).run("layer_case", tables=TABLES, features=FEATURES,
                       inputs=inputs, logical=logical, steps=2)
    for r, out in enumerate(got):
        assert out["num_shards"] == D and out["shard"] == r
        for k, v in out["acts"].items():
            close(v, rows(j_acts[k], r, D), what=f"{k} rank {r}")
        close(out["losses"], j_losses, what="losses")
    want = j_after.get_embedding_tables()
    for r, out in enumerate(got):
        for name, t in out["tables"].items():
            close(t, want[name], what=f"{name} rank {r}")
            assert not np.array_equal(t, logical[name]), name


def test_comm_bf16_close_to_f32_and_to_jax(ranks):
    D = 4
    inputs = inputs_of(FEATURES, seed=21)
    jl = jax_layer(D, comm_dtype="bfloat16")
    logical = {k: np.asarray(v)
               for k, v in jl.get_embedding_tables().items()}
    j_acts = jl(jl.preprocess(inputs))
    j_losses, j_after = _jax_train(jl, inputs, steps=1)
    runs = {c: ranks(D).run("layer_case", tables=TABLES, features=FEATURES,
                            inputs=inputs, logical=logical, steps=1,
                            comm_dtype=c)
            for c in (None, "bfloat16")}
    for r in range(D):
        f32, b16 = runs[None][r], runs["bfloat16"][r]
        for k in b16["acts"]:
            close(b16["acts"][k], f32["acts"][k], rtol=2e-2, atol=1e-2)
            close(b16["acts"][k], rows(j_acts[k], r, D), rtol=2e-2,
                  atol=1e-2)
        assert abs(b16["losses"][0] - f32["losses"][0]) < (
            1e-2 * abs(f32["losses"][0]))
        assert abs(b16["losses"][0] - j_losses[0]) < 1e-2 * abs(j_losses[0])
        for name, t in b16["tables"].items():
            close(t, f32["tables"][name], rtol=2e-2, atol=2e-4)
            close(t, j_after.get_embedding_tables()[name], rtol=2e-2,
                  atol=2e-4)


# tests/test_2d_mesh.py's layer, on 4 ranks.
MESH_TABLES = [dict(name="t", vocab=97, dim=8, combiner="mean",
                    optimizer="adagrad", max_ids=64, max_unique=64)]
MESH_FEATURES = [dict(name="f", table="t", input_shape=(32, 3),
                      output_shape=(32, 8))]


@pytest.mark.parametrize("sizes", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_2d_mesh_matches_1d(ranks, sizes):
    rng = np.random.default_rng(0)
    inputs = {"f": rng.integers(0, 97, (32, 3))}
    axes = ("model", "data")
    j1 = JaxEmbedding(jax_configs(MESH_TABLES, MESH_FEATURES),
                      key=jax.random.key(0),
                      mesh=jmesh.create_mesh(jax.devices()[:4]))
    logical = {k: np.asarray(v)
               for k, v in j1.get_embedding_tables().items()}
    j2 = JaxEmbedding(jax_configs(MESH_TABLES, MESH_FEATURES),
                      key=jax.random.key(0),
                      mesh=jmesh.create_mesh(jax.devices()[:4], axes,
                                             sizes),
                      axis_name=axes)
    j2.set_embedding_tables(logical)
    want = np.asarray(j2(j2.preprocess(inputs))["f"])
    one = ranks(4).run("layer_case", tables=MESH_TABLES,
                       features=MESH_FEATURES, inputs=inputs,
                       logical=logical, steps=1)
    two = ranks(4).run("layer_case", tables=MESH_TABLES,
                       features=MESH_FEATURES, inputs=inputs,
                       logical=logical, steps=1, axes=axes, sizes=sizes)
    for r in range(4):
        assert two[r]["num_shards"] == 4 and two[r]["shard"] == r
        np.testing.assert_allclose(two[r]["acts"]["f"], one[r]["acts"]["f"],
                                   rtol=1e-5, atol=1e-6)
        close(two[r]["acts"]["f"], rows(want, r, 4))
        assert two[r]["losses"] == one[r]["losses"]
        np.testing.assert_array_equal(two[r]["tables"]["t"],
                                      one[r]["tables"]["t"])


# tests/test_shard_rotation.py's four tables, on 4 ranks.
ROT_TABLES = [dict(name=f"t{t}", vocab=64, dim=8, max_ids=256,
                   max_unique=256) for t in range(4)]
ROT_FEATURES = [dict(name=f"f{t}", table=f"t{t}", input_shape=(8, 4),
                     output_shape=(8, 8)) for t in range(4)]


def test_rotation_places_rows_as_the_jax_layout(ranks):
    D = 4
    (jstack,) = jstacking.build_stacks(
        jax_configs(ROT_TABLES, ROT_FEATURES, "list"), D)
    assert [t.rotation for t in jstack.tables] == [0, 1, 2, 3]
    values = {
        t.name: (np.arange(t.vocabulary_size, dtype=np.float32)[:, None]
                 * np.ones((1, t.embedding_dim), np.float32)
                 + 1000 * i)
        for i, t in enumerate(jstack.tables)
    }
    stacked = np.zeros((jstack.global_rows, jstack.stack_dim), np.float32)
    for name, v in values.items():
        stacked = jstacking.scatter_table(jstack, stacked, name, v)
    got = ranks(D).run("rotation_case", tables=ROT_TABLES,
                       features=ROT_FEATURES, values=values, seed=3)
    R = jstack.rows_per_shard
    # The logical tables the initializer draws do not depend on D.
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )
    one = DistributedEmbedding(
        workers.feature_configs(ROT_TABLES, ROT_FEATURES),
        generator=torch.Generator().manual_seed(3), device="cpu")
    drawn = {k: v.numpy() for k, v in one.get_embedding_tables().items()}
    for r, out in enumerate(got):
        assert out["rows_per_shard"] == [R]
        np.testing.assert_array_equal(out["local"][0],
                                      stacked[r * R : (r + 1) * R])
        for name, v in values.items():
            np.testing.assert_array_equal(out["gathered"][name], v)
            np.testing.assert_array_equal(out["drawn"][name], drawn[name])


def test_has_sharded_tables_follows_the_mesh(ranks):
    auto = [dict(TABLES[1], placement="auto")]
    feats = [FEATURES[1]]
    inputs = inputs_of(feats, seed=4)
    got = ranks(2).run("layer_case", tables=auto, features=feats,
                       inputs=inputs)
    assert [g["has_sharded_tables"] for g in got] == [True, True]
    j = JaxEmbedding(jax_configs(auto, feats), key=jax.random.key(0),
                     mesh=jmesh.create_mesh(jax.devices()[:2]))
    assert j.has_sharded_tables()
    from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
        DistributedEmbedding,
    )
    one = DistributedEmbedding(workers.feature_configs(auto, feats),
                               device="cpu")
    j1 = JaxEmbedding(jax_configs(auto, feats), key=jax.random.key(0),
                      mesh=jmesh.create_mesh(jax.devices()[:1]))
    assert one.has_sharded_tables() is j1.has_sharded_tables() is False


@pytest.mark.parametrize("D", [2, 4])
def test_parallel_helpers_match_the_jax_layout(ranks, D):
    got = ranks(D).run("parallel_case")
    mesh = jmesh.create_mesh(jax.devices()[:D])
    x = np.arange(4 * D)
    shards = jmesh.put_batch(mesh, x).addressable_shards
    for r, out in enumerate(got):
        assert out["index"] == r and out["process"] == (r, D)
        # put_batch / batch_sharding: device r's rows of dim 0.
        want = np.asarray(next(s.data for s in shards
                               if s.device == jax.devices()[r]))
        assert out["put_x"] == want.tolist()
        assert out["rows"] == (4 * r, 4 * r + 4)
        assert out["put_y"] == [2 * r, 2 * r + 1]
        assert out["replicated"] == ([0.0, 0.0, 0.0], [0])
        assert out["allgather"] == [[i, 10 * i] for i in range(D)]
        # sync_max_stats: max of watermarks, sum of dropped ids.
        assert out["stats"] == {"max_ids": D,
                                "dropped_ids": sum(i + 2 for i in range(D))}
        assert out["host"] == [r, r]
    if D == 4:
        mesh2 = jmesh.create_mesh(jax.devices()[:4], ("model", "data"),
                                  (2, 2))
        assert jmesh.axis_size(mesh2, ("model", "data")) == 4
        for r, out in enumerate(got):
            assert out["two"] == {"index": r, "model": r // 2,
                                  "data": r % 2, "world_group": True,
                                  "data_group_size": 2}


def test_default_backend_is_nccl_on_cuda0():
    """No device given means cuda:0 and NCCL, as everywhere in the port:
    without CUDA that raises rather than starting a gloo group."""
    import torch.distributed as dist

    from keras_rs_tpu_torch.parallel import multihost

    assert multihost.default_backend("cuda:1") == "nccl"
    assert multihost.default_backend("cpu") == "gloo"
    if torch.cuda.is_available():
        assert multihost.default_backend() == "nccl"
        return
    with pytest.raises(RuntimeError, match="No CUDA device"):
        multihost.default_backend()
    with pytest.raises(RuntimeError, match="No CUDA device"):
        multihost.initialize(world_size=2, rank=0,
                             init_method="tcp://localhost:1")
    assert not dist.is_initialized()


def test_one_process_helpers_are_the_identity():
    from keras_rs_tpu.parallel import multihost as jmulti
    from keras_rs_tpu_torch.parallel import mesh as mesh_lib
    from keras_rs_tpu_torch.parallel import multihost

    mesh = mesh_lib.create_mesh("cpu")
    assert mesh.size == 1 and mesh.group("data") is None
    assert mesh.index("data") == 0
    assert multihost.initialize("cpu") is False
    assert multihost.initialize() is False  # one process: nothing starts
    stats ={"max_ids": 3, "dropped_ids": 2}
    assert multihost.sync_max_stats(stats) == jmulti.sync_max_stats(stats)
    a = np.arange(3)
    np.testing.assert_array_equal(multihost.process_allgather(a),
                                  jmulti.process_allgather(a))
