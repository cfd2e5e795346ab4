"""The port's jax-free stacking, COO preprocessing and synthetic data
against the JAX package's. Everything here is integer layout or the same
numpy float expression, so every comparison is bit-exact."""

from contextlib import nullcontext

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.data import synthetic as jax_synthetic
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import preprocessing as jax_pre
from keras_rs_tpu.layers.embedding import stacking as jax_stacking
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import preprocessing
from keras_rs_tpu_torch.layers.embedding import stacking

B = 64
# (name, vocab, valence, combiner): one stack with mixed combiners, so
# the divisor fold runs, plus a table whose vocab is not a multiple of D.
TABLES = [
    ("t_big", 2000, 3, "sum"),
    ("t_mid", 1501, 2, "mean"),
    ("t_small", 50, 4, "sqrtn"),
]


def _feature_configs(cfg_mod, C, U):
    fcs = []
    for name, vocab, valence, combiner in TABLES:
        table = cfg_mod.TableConfig(
            name=name,
            vocabulary_size=vocab,
            embedding_dim=128,
            optimizer="adagrad",
            combiner=combiner,
            placement="sharded",
            max_ids_per_partition=C,
            max_unique_ids_per_partition=U,
        )
        fcs.append(
            cfg_mod.FeatureConfig(
                name=f"f_{name}",
                table=table,
                input_shape=(B, valence),
                output_shape=(B, 128),
            )
        )
    return fcs


def _inputs(seed):
    rng = np.random.default_rng(seed)
    ids, weights = {}, {}
    for name, vocab, valence, _ in TABLES:
        x = rng.integers(-5, vocab + 5, size=(B, valence))  # some invalid
        w = rng.uniform(0.5, 2.0, size=(B, valence)).astype(np.float32)
        w[rng.random((B, valence)) < 0.2] = 0.0  # padding positions
        ids[f"f_{name}"] = x
        weights[f"f_{name}"] = w
    return ids, weights


def _stacks(num_shards, C, U):
    ours = stacking.build_stacks(_feature_configs(config, C, U), num_shards)
    ref = jax_stacking.build_stacks(
        _feature_configs(jax_config, C, U), num_shards
    )
    return ours, ref


# (D, C, U): D = 1 at worst-case capacity (the construction-order forward
# applies), D = 1 with capacities small enough to drop ids, and D = 2 and
# D = 4 (rotation, bucketing; no construction-order arrays).
LAYOUTS = [
    (1, 9 * B, 9 * B), (1, 200, 150), (2, 9 * B, 9 * B), (4, 9 * B, 9 * B),
]


@pytest.mark.parametrize("num_shards, C, U", LAYOUTS)
def test_stack_layout_matches_jax(num_shards, C, U):
    ours, ref = _stacks(num_shards, C, U)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        for field in ("name", "num_shards", "stack_dim", "rows_per_shard",
                      "max_ids_per_partition", "max_unique_ids_per_shard",
                      "packed_state", "state_stride", "sink_slot",
                      "construction_fwd"):
            assert getattr(o, field) == getattr(r, field), field
        for ot, rt in zip(o.tables, r.tables):
            assert vars(ot) == vars(rt)
        for of, rf in zip(o.features, r.features):
            assert vars(of) == vars(rf)


@pytest.mark.parametrize("num_shards, C, U", LAYOUTS)
@pytest.mark.parametrize("with_weights", [True, False])
def test_preprocess_matches_jax_bit_exact(num_shards, C, U, with_weights):
    (ours,), (ref,) = _stacks(num_shards, C, U)
    ids, weights = _inputs(seed=num_shards + C)
    w = weights if with_weights else None

    def drops():  # the small capacities drop ids, with a warning
        return pytest.warns(UserWarning) if C == 200 else nullcontext()

    with drops():
        coo, stats = preprocessing.preprocess_stack(ours, ids, w)
    with drops():
        jcoo, jstats = jax_pre.preprocess_stack(ref, ids, w,
                                                backend="numpy")
    assert vars(stats) == vars(jstats)
    got, want = coo.arrays(), jcoo.arrays()
    assert got.keys() == want.keys()
    if ours.construction_fwd:
        assert {"fwd_slots", "fwd_gains"} <= got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gather_scatter_table_match_jax_layout():
    (ours,), (ref,) = _stacks(2, 9 * B, 9 * B)
    rng = np.random.default_rng(0)
    tables = {
        name: rng.standard_normal((vocab, 128)).astype(np.float32)
        for name, vocab, _, _ in TABLES
    }
    jax_state = np.zeros((ref.global_rows, 2, 128), np.float32)
    state = torch.zeros((ours.global_rows, 2, 128))
    for name, values in tables.items():
        jax_state = jax_stacking.scatter_table(ref, jax_state, name, values)
        stacking.scatter_table(ours, state, name, torch.from_numpy(values))
    np.testing.assert_array_equal(state.numpy(), jax_state)
    for name, values in tables.items():
        np.testing.assert_array_equal(
            stacking.gather_table(ours, state, name).numpy(), values
        )


def test_criteo_like_batch_matches_jax():
    kw = dict(vocab_sizes=[2000, 1500, 50], multi_hot_sizes=[3, 2, 1],
              seed=5)
    ours = synthetic.criteo_like_batch(B, **kw)
    ref = jax_synthetic.criteo_like_batch(B, **kw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
