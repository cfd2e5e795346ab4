"""The port's three COO backends against each other: the C++ engine
(native/coo_preprocess.cc through layers/embedding/native.py), the numpy
path and the device transform (on CPU tensors), with and without drops.
Every array and every stat is bit-exact. The engine builds into
build/keras_rs_tpu_torch/, never beside its source under native/."""

import warnings

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch.layers.embedding import native, preprocessing
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    preprocess_stack_device,
)
from keras_rs_tpu_torch.layers.embedding.stacking import build_stacks
from keras_rs_tpu_torch.utils import native_build

B = 32
D = 8


def make_stack(combiners=("mean", "sum", "sqrtn"), C=16, U=16):
    """The JAX test's stack: three tables of growing valence, and a 1-D
    feature sharing table 0."""
    tables = [
        TableConfig(
            f"t{i}", 40 + 13 * i, 8, optimizer="sgd", combiner=c,
            max_ids_per_partition=C, max_unique_ids_per_partition=U,
        )
        for i, c in enumerate(combiners)
    ]
    fcs = [FeatureConfig(f"f{i}", t, (B, i + 1), (B, 8))
           for i, t in enumerate(tables)]
    fcs.append(FeatureConfig("f_shared", tables[0], (B,), (B, 8)))
    (stack,) = build_stacks(fcs, D)
    return stack


def make_inputs(stack, seed, with_weights=True):
    rng = np.random.default_rng(seed)
    inputs, weights = {}, {}
    for f in stack.features:
        vocab = stack.table_spec(f.table_name).vocabulary_size
        shape = (B, f.valence) if f.valence > 1 else (B,)
        inputs[f.name] = rng.integers(-2, vocab + 3, size=shape)
        if with_weights:
            w = rng.random(shape).astype(np.float32)
            w[rng.random(w.shape) < 0.2] = 0.0
            weights[f.name] = w
    return inputs, (weights if with_weights else None)


def three_backends(stack, inputs, weights):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {
            backend: preprocessing.preprocess_stack(
                stack, inputs, weights, backend=backend)
            for backend in ("numpy", "native")
        }
    t_w = (None if weights is None else
           {k: torch.from_numpy(v) for k, v in weights.items()})
    coo, stats = preprocess_stack_device(
        stack, {k: torch.from_numpy(v) for k, v in inputs.items()}, t_w)
    out["device"] = (
        preprocessing.CooBatch(**{k: v.numpy()
                                  for k, v in coo.arrays().items()}),
        preprocessing.InputStats(*(int(x) for x in stats)),
    )
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_weights", [True, False])
def test_native_numpy_device_bit_exact(seed, with_weights):
    stack = make_stack()
    out = three_backends(stack, *make_inputs(stack, seed, with_weights))
    want, want_stats = out["numpy"]
    for backend in ("native", "device"):
        coo, stats = out[backend]
        assert coo.arrays().keys() == want.arrays().keys(), backend
        for name, a in want.arrays().items():
            b = coo.arrays()[name]
            assert a.dtype == b.dtype, (backend, name)
            np.testing.assert_array_equal(b, a, err_msg=f"{backend} {name}")
        assert stats == want_stats, backend


def test_native_numpy_device_bit_exact_with_drops():
    stack = make_stack(C=2, U=4)
    inputs, weights = make_inputs(stack, 5)
    with pytest.warns(UserWarning):
        preprocessing.preprocess_stack(stack, inputs, weights,
                                       backend="native")
    out = three_backends(stack, inputs, weights)
    want, want_stats = out["numpy"]
    assert want_stats.dropped_ids > 0
    for backend in ("native", "device"):
        coo, stats = out[backend]
        for name, a in want.arrays().items():
            np.testing.assert_array_equal(coo.arrays()[name], a,
                                          err_msg=f"{backend} {name}")
        assert stats == want_stats, backend


def test_single_shard_construction_arrays_bit_exact():
    """D = 1 with room for every entry: all three backends also emit the
    construction-order arrays of the lookup's forward."""
    tables = [TableConfig(f"t{i}", 1000 + i, 8, optimizer="sgd",
                          combiner="sum", max_ids_per_partition=4 * B * 3,
                          max_unique_ids_per_partition=4 * B * 3)
              for i in range(2)]
    fcs = [FeatureConfig(f"f{i}", t, (4 * B, i + 1), (4 * B, 8))
           for i, t in enumerate(tables)]
    (stack,) = build_stacks(fcs, 1)
    rng = np.random.default_rng(9)
    inputs = {f.name: rng.integers(0, 1000, size=(4 * B, f.valence))
              for f in stack.features}
    out = three_backends(stack, inputs, None)
    want, want_stats = out["numpy"]
    assert want.fwd_slots is not None
    for backend in ("native", "device"):
        coo, stats = out[backend]
        for name, a in want.arrays().items():
            np.testing.assert_array_equal(coo.arrays()[name], a,
                                          err_msg=f"{backend} {name}")
        assert stats == want_stats


def test_engine_builds_under_build_dir():
    lib = native.get_lib()
    assert lib is not None
    path = native_build.library_path("coo_preprocess")
    assert path.parent == native_build.BUILD_DIR and path.exists()
    assert lib._name == str(path)


def test_native_backend_raises_without_engine(monkeypatch):
    """backend="native" never falls back; "auto" takes numpy."""
    stack = make_stack()
    inputs, weights = make_inputs(stack, 0)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="could not be built"):
        preprocessing.preprocess_stack(stack, inputs, weights,
                                       backend="native")
    coo, _ = preprocessing.preprocess_stack(stack, inputs, weights,
                                            backend="auto")
    want, _ = preprocessing.preprocess_stack(stack, inputs, weights,
                                             backend="numpy")
    for name, a in want.arrays().items():
        np.testing.assert_array_equal(coo.arrays()[name], a)
    with pytest.raises(ValueError, match="Unknown backend"):
        preprocessing.preprocess_stack(stack, inputs, weights,
                                       backend="cuda")
