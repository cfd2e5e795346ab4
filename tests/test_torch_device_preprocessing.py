"""The port's device COO transform (layers/embedding/device_preprocessing.py,
run here on CPU tensors) against the JAX package's
`preprocess_stack_device` (jit on the CPU) and against the port's numpy
path, on every case of tests/test_device_preprocessing.py, and one DLRM
training step from raw ids against the JAX model's device-preprocessing
step.

Bounds: integer arrays and stats bit-exact; send_gains, fwd_gains and
divisors within rtol 1e-6 where a stack has a mean or sqrtn combiner
(the divisors are sums, which the port takes with index_add_: on CUDA its
float atomics may add in another order), and bit-exact for all-sum stacks,
which never divide. DLRM step losses and tables within 1e-5 (f32 dense
stack), as tests/test_torch_dlrm.py holds the host path.
"""

import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from torch_parity import B as DLRM_B
from torch_parity import LR, MULTI_HOT, VOCAB, build_pair

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.layers.embedding import config as jax_config
from keras_rs_tpu.layers.embedding import device_preprocessing as jax_dev
from keras_rs_tpu.layers.embedding import stacking as jax_stacking
from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.embedding import config
from keras_rs_tpu_torch.layers.embedding import preprocessing
from keras_rs_tpu_torch.layers.embedding import stacking
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    preprocess_stack_device,
)
from keras_rs_tpu_torch.models import dlrm as torch_dlrm
from keras_rs_tpu_torch.training import train_state

INT_KEYS = ("send_slots", "send_segs", "unique_slots", "entry_unique",
            "fwd_slots")
FLOAT_KEYS = ("send_gains", "divisors", "fwd_gains")


def _make_stacks(num_shards=4, batch=32, combiners=("mean", "sum"),
                 vocabs=(97, 53), dims=(8, 8), max_ids=64, max_unique=64,
                 valence=4):
    """The same single stack in both packages (the JAX test's shapes)."""

    def build(mod, stacking_mod):
        tables = [
            mod.TableConfig(
                name=f"t{i}", vocabulary_size=v, embedding_dim=d,
                combiner=c, max_ids_per_partition=max_ids,
                max_unique_ids_per_partition=max_unique,
            )
            for i, (v, d, c) in enumerate(zip(vocabs, dims, combiners))
        ]
        feats = [
            mod.FeatureConfig(
                name=f"f{i}", table=t, input_shape=(batch, valence),
                output_shape=(batch, t.embedding_dim),
            )
            for i, t in enumerate(tables)
        ]
        (stack,) = stacking_mod.build_stacks(feats, num_shards)
        return stack

    return build(config, stacking), build(jax_config, jax_stacking)


def _rand_inputs(stack, seed=0, valence=4, pad_frac=0.25):
    rng = np.random.default_rng(seed)
    B = stack.batch_size
    inputs, weights = {}, {}
    for fspec in stack.features:
        vocab = stack.table_spec(fspec.table_name).vocabulary_size
        inputs[fspec.name] = rng.integers(0, vocab, (B, valence))
        w = (rng.random((B, valence)) > pad_frac).astype(np.float32)
        w *= rng.random((B, valence)).astype(np.float32) + 0.5
        weights[fspec.name] = w
    return inputs, weights


def _check(stacks, inputs, weights):
    """The port's device transform against JAX's and the port's numpy
    path; returns the port's stats."""
    ours, ref = stacks
    all_sum = all(t.combiner == "sum" for t in ours.tables)
    t_in = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    t_w = (None if weights is None else
           {k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # capacity drops warn on the host
        host, hstats = preprocessing.preprocess_stack(
            ours, inputs, weights, backend="numpy")
    dev, dstats = preprocess_stack_device(ours, t_in, t_w)
    jdev, jstats = jax.jit(
        lambda i, w: jax_dev.preprocess_stack_device(ref, i, w)
    )(inputs, weights)

    got = {k: v.numpy() for k, v in dev.arrays().items()}
    want_host = host.arrays()
    assert got.keys() == want_host.keys()
    assert set(jdev) == set(got)
    for k, v in got.items():
        for name, want in (("numpy", want_host[k]),
                           ("jax", np.asarray(jdev[k]))):
            assert v.dtype == want.dtype, (k, name)
            assert v.shape == want.shape, (k, name)
            if k in INT_KEYS or all_sum:
                np.testing.assert_array_equal(v, want,
                                              err_msg=f"{k} vs {name}")
            else:
                np.testing.assert_allclose(v, want, rtol=1e-6,
                                           err_msg=f"{k} vs {name}")
    for field in ("max_ids_per_bucket", "max_unique_per_shard",
                  "dropped_ids"):
        value = getattr(dstats, field)
        assert value.dtype == torch.int32 and value.ndim == 0
        assert int(value) == getattr(hstats, field) == int(
            getattr(jstats, field)), field
    return dstats


@pytest.mark.parametrize("combiners", [("mean", "sum"), ("sqrtn", "mean")])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_host_oracle(combiners, seed):
    stacks = _make_stacks(combiners=combiners)
    _check(stacks, *_rand_inputs(stacks[0], seed=seed))


def test_capacity_overflow_drops_match():
    stacks = _make_stacks(max_ids=3, max_unique=8)
    stats = _check(stacks, *_rand_inputs(stacks[0], seed=2))
    assert int(stats.dropped_ids) > 0


def test_invalid_ids_ignored():
    stacks = _make_stacks()
    inputs, weights = _rand_inputs(stacks[0], seed=3)
    f0 = stacks[0].features[0].name
    inputs[f0] = np.asarray(inputs[f0]).copy()
    inputs[f0][0, 0] = -7
    inputs[f0][1, 1] = 10**6
    _check(stacks, inputs, weights)


def test_no_weights_and_1d_inputs():
    stacks = _make_stacks()
    stack = stacks[0]
    rng = np.random.default_rng(4)
    inputs = {
        f.name: rng.integers(
            0, stack.table_spec(f.table_name).vocabulary_size,
            (stack.batch_size,))
        for f in stack.features
    }
    _check(stacks, inputs, None)


@pytest.mark.parametrize("combiners", [("mean", "sum"), ("sum", "sum")],
                         ids=["mean_sum", "all_sum"])
def test_single_shard_fast_path(combiners):
    """D = 1 takes the slice fast path and emits the construction-order
    arrays (here C >= every entry); all-sum gains are exact."""
    stacks = _make_stacks(num_shards=1, batch=24, combiners=combiners,
                          max_ids=200, max_unique=32)
    assert stacks[0].construction_fwd
    _check(stacks, *_rand_inputs(stacks[0], seed=7))


def test_single_shard_small_capacity():
    """D = 1 below the entry count: entries and uniques dropped, and no
    construction-order arrays."""
    stacks = _make_stacks(num_shards=1, batch=24, max_ids=40, max_unique=32)
    assert not stacks[0].construction_fwd
    _check(stacks, *_rand_inputs(stacks[0], seed=7))


def test_single_shard_capacity_exceeds_entries():
    stacks = _make_stacks(num_shards=1, batch=8, max_ids=4096,
                          max_unique=64)
    _check(stacks, *_rand_inputs(stacks[0], seed=8))


def test_empty_shard_dedup_matches_host():
    stacks = _make_stacks(num_shards=2, batch=8, vocabs=(40, 24),
                          max_ids=32, max_unique=16)
    stack = stacks[0]
    inputs = {}
    for f in stack.features:
        t = stack.table_spec(f.table_name)
        ids = (np.arange(stack.batch_size * 4).reshape(-1, 4) * 2) % (
            t.vocabulary_size - t.vocabulary_size % 2)
        inputs[f.name] = ids + (t.rotation % 2)
    _check(stacks, inputs, None)
    dev, _ = preprocess_stack_device(
        stack, {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert bool((dev.unique_slots[1] == stack.sink_slot).all())


@pytest.mark.parametrize("case", range(8))
def test_fuzz_parity(case):
    """Random shard counts, features, valences, capacities, weights and
    out-of-range ids (the JAX test's generator)."""
    rng = np.random.default_rng(1000 + case)
    num_shards = int(rng.choice([1, 2, 4, 8]))
    n_feats = int(rng.integers(1, 4))
    batch = num_shards * int(rng.integers(2, 6))
    combiners = [str(rng.choice(["mean", "sum", "sqrtn"]))
                 for _ in range(n_feats)]
    vocabs = [int(rng.integers(16, 200)) for _ in range(n_feats)]
    max_ids = int(rng.integers(8, 64))
    stacks = _make_stacks(
        num_shards=num_shards, batch=batch, combiners=combiners,
        vocabs=vocabs, dims=[8] * n_feats, max_ids=max_ids,
        max_unique=int(rng.integers(8, 64)),
    )
    valence = int(rng.integers(1, 6))
    inputs, weights = {}, {}
    for fspec in stacks[0].features:
        vocab = stacks[0].table_spec(fspec.table_name).vocabulary_size
        inputs[fspec.name] = rng.integers(-3, vocab + 5, (batch, valence))
        w = (rng.random((batch, valence)) > 0.3).astype(np.float32)
        w *= rng.random((batch, valence)).astype(np.float32) + 0.25
        weights[fspec.name] = w
    _check(stacks, inputs, weights)


def test_dlrm_step_from_raw_ids_matches_jax():
    """Three training steps from raw ids through preprocess_on_device
    (the COO transform inside the step) in both packages, from the same
    parameters; the port's device and host paths give equal losses."""
    f32 = dict(compute_dtype=None, dense_output_dtype="float32")
    batches = [
        synthetic.criteo_like_batch(DLRM_B, vocab_sizes=VOCAB,
                                    multi_hot_sizes=MULTI_HOT, seed=s)
        for s in (0, 1, 0)
    ]
    jmodel, tmodel = build_pair(seed=2, **f32)
    _, thost = build_pair(seed=2, **f32)

    opt = optax.adagrad(LR)
    state = jax_training.create_train_state(jmodel, opt)
    jstep = jax_training.make_train_step(
        lambda m, b: jax_dlrm.bce_loss(m, m.preprocess_on_device(b)), opt,
        donate=False)
    j_losses = []
    for raw in batches:
        state, loss = jstep(state, raw)
        j_losses.append(float(loss))

    def run(model, loss_fn, prepare):
        step = train_state.make_train_step(
            model, loss_fn,
            train_state.DenseAdagrad(model.parameters(), LR))
        return [float(step(prepare(raw))) for raw in batches]

    t_losses = run(
        tmodel,
        lambda m, b: torch_dlrm.bce_loss(m, m.preprocess_on_device(b)),
        tmodel.to_device)
    h_losses = run(thost, torch_dlrm.bce_loss, thost.preprocess)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-5)
    assert t_losses == h_losses
    j_tables = state.model.embedding_layer.get_embedding_tables()
    for name, t in tmodel.embedding_layer.get_embedding_tables().items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j_tables[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
