"""Nests of feature configs (ROADMAP C7) and the small names of ROADMAP
A14, each held to the JAX package.

C7: the port's DistributedEmbedding and FrozenEmbedding take a list,
nested dicts or one bare FeatureConfig, order the features as
jax.tree_util does (dict keys sorted), return activations in the
configs' nest, and bind inputs given as a nest of that structure, a flat
dict keyed by feature names, or a bare array for a one-feature layer;
any other structure raises ValueError (tests/test_round2_fixes.py:
125-140). Activations from the same logical tables within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

import keras_rs_tpu
import keras_rs_tpu_torch
from keras_rs_tpu.layers.embedding import config as jconfig
from keras_rs_tpu.layers.embedding import optimizers as jopt
from keras_rs_tpu.layers.embedding.distributed_embedding import (
    DistributedEmbedding as JaxEmbedding,
)
from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu.utils import doc_utils as jdoc
from keras_rs_tpu.utils import shape_utils as jshape
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import optimizers as opt
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.utils import doc_utils, shape_utils

B = 16


def _tables(lib, placement="sharded"):
    # Capacities for every id of the batch: nothing is dropped, so the
    # frozen lookup (no capacities) gives the same activations.
    t = lib.TableConfig("t", 100, 8, optimizer="sgd", combiner="sum",
                        placement=placement, max_ids_per_partition=256,
                        max_unique_ids_per_partition=256)
    u = lib.TableConfig("u", 50, 8, optimizer="adagrad", combiner="mean",
                        placement=placement, max_ids_per_partition=256,
                        max_unique_ids_per_partition=256)
    return t, u


def _nests(lib, placement="sharded"):
    t, u = _tables(lib, placement)
    fa = lib.FeatureConfig("a", t, (B, 4), (B, 8))
    fb = lib.FeatureConfig("b", t, (B, 4), (B, 8))
    fc = lib.FeatureConfig("c", u, (B, 2), (B, 8))
    return {
        "list": [fa, fb, fc],
        "nested_dict": {"g": {"a": fa, "c": fc}, "h": fb},
        "renamed_dict": {"x": fb, "y": fa, "z": fc},
        "tuple_in_dict": {"pair": (fa, fc), "one": fb},
        "bare": fa,
    }


def _inputs(nest_name, lib_nest):
    rng = np.random.default_rng(0)
    ids = {"a": rng.integers(0, 100, (B, 4)), "b": rng.integers(0, 100,
                                                                (B, 4)),
           "c": rng.integers(0, 50, (B, 2))}

    def to_nest(x):
        if isinstance(x, dict):
            return {k: to_nest(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_nest(v) for v in x)
        return ids[x.name]

    return ids, to_nest(lib_nest)


def _pair(nest_name):
    j = JaxEmbedding(_nests(jconfig)[nest_name], key=jax.random.key(0),
                     mesh=jmesh.create_mesh(jax.devices()[:1]))
    t = DistributedEmbedding(_nests(config)[nest_name], device="cpu")
    t.set_embedding_tables({k: np.asarray(v) for k, v in
                            j.get_embedding_tables().items()})
    return j, t


def _assert_same_nest(got, want):
    jax_leaves, jax_def = jax.tree_util.tree_flatten(want)
    t_leaves, t_def = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda x: x.numpy(), got))
    assert t_def == jax_def
    for a, b in zip(t_leaves, jax_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nest_name", sorted(_nests(config)))
def test_nests_bind_and_return_as_jax(nest_name):
    j, t = _pair(nest_name)
    assert ([fc.name for fc in t._feature_leaves]
            == [fc.name for fc in j._feature_leaves])
    assert [s.name for s in t.stacks] == [s.name for s in j.stacks]
    by_name, nested = _inputs(nest_name, _nests(config)[nest_name])
    want = j(j.preprocess(nested))
    with torch.no_grad():
        _assert_same_nest(t(t.preprocess(nested)), want)
        # A flat dict keyed by feature names binds too (for a bare
        # config, so does the bare array).
        names = {fc.name for fc in t._feature_leaves}
        flat = {k: v for k, v in by_name.items() if k in names}
        _assert_same_nest(t(t.preprocess(flat)), want)
        frozen = t.freeze()
        _assert_same_nest(frozen(nested), want)
        _assert_same_nest(frozen(flat), want)


def test_get_config_rebuilds_a_list_as_jax():
    j, t = _pair("nested_dict")
    cfg = t.get_config()
    jcfg = j.get_config()
    assert cfg["features"] == jcfg["features"]
    back = DistributedEmbedding.from_config(dict(cfg, device="cpu"))
    jback = JaxEmbedding.from_config(jcfg, key=jax.random.key(0),
                                     mesh=jmesh.create_mesh(
                                         jax.devices()[:1]))
    assert isinstance(back._feature_leaves, list)
    assert back._feature_structure == ("list", ("*", "*", "*"))
    assert isinstance(jback._feature_treedef.unflatten([0, 0, 0]), list)


def test_a_trained_layer_is_freed_without_a_garbage_collection():
    # The nest helpers make no reference cycle: once the caller drops the
    # layer and its activations, the stacked state goes at once (a cycle
    # through an activation's autograd node would keep it until gc).
    import gc
    import weakref

    gc.disable()
    try:
        _, t = _pair("nested_dict")
        _, nested = _inputs("nested_dict", _nests(config)["nested_dict"])
        out = t(t.preprocess(nested))
        sum(v.sum() for v in jax.tree_util.tree_leaves(out)).backward()
        state = weakref.ref(t.stack_state(0)["table"])
        del t, out
        assert state() is None
    finally:
        gc.enable()


# tests/test_round2_fixes.py:104-140.
def _one_feature(lib):
    t = lib.TableConfig("t", 100, 8, optimizer="sgd", combiner="sum",
                        placement="sharded", max_ids_per_partition=4,
                        max_unique_ids_per_partition=4)
    return [lib.FeatureConfig("f", t, (B, 4), (B, 8))]


def _two_features(lib):
    t = lib.TableConfig("t", 100, 8, optimizer="sgd", combiner="sum",
                        placement="sharded", max_ids_per_partition=64,
                        max_unique_ids_per_partition=64)
    return {"a": lib.FeatureConfig("a", t, (B, 4), (B, 8)),
            "b": lib.FeatureConfig("b", t, (B, 4), (B, 8))}


def test_wrong_structure_same_leaf_count_raises():
    ids = np.zeros((B, 4), np.int64)
    j = JaxEmbedding(_two_features(jconfig), key=jax.random.key(0))
    with pytest.raises(ValueError, match="structure"):
        j.preprocess([ids, ids])
    t = DistributedEmbedding(_two_features(config), device="cpu")
    with pytest.raises(ValueError, match="structure"):
        t.preprocess([ids, ids])


def test_matching_dict_ok():
    ids = np.zeros((B, 4), np.int64)
    t = DistributedEmbedding(_two_features(config), device="cpu")
    t.preprocess({"a": ids, "b": ids})


def test_bare_leaf_ok_for_single_feature():
    ids = np.zeros((B, 4), np.int64)
    t = DistributedEmbedding(_one_feature(config), device="cpu")
    with pytest.warns(UserWarning):  # 64 ids of id 0 over capacity 4
        pre = t.preprocess(ids)
    with torch.no_grad():
        out = t(pre)
    assert isinstance(out, list) and out[0].shape == (B, 8)


@pytest.mark.parametrize("bad", [
    "list_for_dict", "unknown_key", "missing_key", "nested_mismatch",
    "bare_for_two",
])
def test_other_structures_raise_as_jax(bad):
    ids = np.zeros((B, 4), np.int64)
    inputs = {
        "list_for_dict": [ids, ids],
        "unknown_key": {"a": ids, "zzz": ids},
        "missing_key": {"a": ids},
        "nested_mismatch": {"a": {"x": ids}, "b": ids},
        "bare_for_two": ids,
    }[bad]
    j = JaxEmbedding(_two_features(jconfig), key=jax.random.key(0))
    with pytest.raises(ValueError):
        j.preprocess(inputs)
    t = DistributedEmbedding(_two_features(config), device="cpu")
    with pytest.raises(ValueError):
        t.preprocess(inputs)
    with pytest.raises(ValueError):
        t.freeze()(inputs)


def test_config_leaves_must_be_feature_configs():
    with pytest.raises(ValueError, match="FeatureConfig"):
        DistributedEmbedding({"a": 3}, device="cpu")
    with pytest.raises(ValueError, match="FeatureConfig"):
        JaxEmbedding({"a": 3}, key=jax.random.key(0))


def test_partial_weights_bind_by_name():
    j, t = _pair("nested_dict")
    by_name, nested = _inputs("nested_dict", _nests(config)["nested_dict"])
    w = {"a": np.linspace(0.5, 1.5, B * 4).reshape(B, 4).astype(np.float32)}
    want = j(j.preprocess(nested, weights=w))
    with torch.no_grad():
        _assert_same_nest(t(t.preprocess(nested, weights=w)), want)


# --- ROADMAP A14 ------------------------------------------------------------

def test_version_matches_jax():
    assert keras_rs_tpu_torch.__version__ == keras_rs_tpu.__version__
    assert keras_rs_tpu_torch.version() == keras_rs_tpu.version()


TEMPLATES = [
    ("Computes {what} over   the {axis} axis of a batch, with a "
     "paragraph long enough to wrap at the chosen width.\n\n"
     "```python\nx = f({what!r})   # kept as it is\n```\n\n"
     "    indented {axis} line kept\nLast words.",
     dict(what="the mean", axis="last")),
    ("Short {x}.", dict(x="line")),
]


@pytest.mark.parametrize("width", [40, 80])
@pytest.mark.parametrize("case", range(len(TEMPLATES)))
def test_format_docstring_matches_jax(case, width):
    template, kwargs = TEMPLATES[case]
    assert (doc_utils.format_docstring(template, width=width, **kwargs)
            == jdoc.format_docstring(template, width=width, **kwargs))


@pytest.mark.parametrize("a, b", [
    ((2, 3), (2, 3)), ((2, None), (2, 5)), ((2, 3), (2, 4)),
    ((2,), (2, 1)), ((None, None), (7, 8)),
])
def test_check_shapes_compatible_matches_jax(a, b):
    assert (shape_utils.check_shapes_compatible(a, b)
            == jshape.check_shapes_compatible(a, b))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_check_rank_matches_jax(rank):
    def outcome(fn):
        try:
            fn(rank, (1, 2), "x")
        except ValueError as e:
            return str(e)
        return None

    assert (outcome(shape_utils.check_rank)
            == outcome(jshape.check_rank))


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rowwise_adagrad",
                                  "adam", "ftrl"])
def test_embedding_optimizer_from_config_round_trips(name):
    ours = opt.get(name)
    theirs = jopt.get(name)
    cfg = ours.get_config()
    assert cfg == theirs.get_config()
    back = type(ours).from_config(cfg)
    assert type(back) is type(ours) and back.get_config() == cfg
    assert (type(theirs).from_config(theirs.get_config()).get_config()
            == cfg)


@pytest.mark.parametrize("placement, want", [
    ("sharded", True), ("auto", False), ("default_device", False)])
def test_has_sharded_tables_at_one_device(placement, want):
    t = DistributedEmbedding(_nests(config, placement)["list"],
                             device="cpu")
    j = JaxEmbedding(_nests(jconfig, placement)["list"],
                     key=jax.random.key(0),
                     mesh=jmesh.create_mesh(jax.devices()[:1]))
    assert t.has_sharded_tables() is j.has_sharded_tables() is want
