"""Capacity growth through the port's DLRM model (ROADMAP C9):
`DLRMDCNv2.preprocess(batch, training=True)` against the JAX model's,
the ml_perf host mode that starts from the config's capacities on
several loader threads, and a COO built before a growth.

Bounds: capacities and dropped-id counts are integers: equal (the JAX
capacities capped at what a batch can fill, where the port's growth
stops, ROADMAP C4). The f32
losses of 3 training steps of the grown models within 1e-5, the f32
bound of tests/test_torch_dlrm.py (the same formulas; matmul and
segment-sum orders differ by a few ulp). A COO built before a growth
gives the same activations, loss and tables after it, bit for bit (the
same arrays through the same code).
"""

import dataclasses
import logging
import sys
import threading
import time
import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from torch_parity import B, LR, MULTI_HOT, VOCAB, build_pair

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.examples.ml_perf import configs
from keras_rs_tpu_torch.examples.ml_perf import main as mlperf
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.models import dlrm as torch_dlrm
from keras_rs_tpu_torch.training import train_state

F32 = dict(compute_dtype=None, dense_output_dtype="float32")
#: Below one batch's ids (B * 5 large-table entries, 320), so the first
#: batches grow them.
START = dict(max_ids_per_partition=64, max_unique_ids_per_partition=32)
LARGE = [i for i, v in enumerate(VOCAB) if v >= 1000]


def _batch(seed: int, valid: float = 1.0, skew: int | None = None) -> dict:
    """A criteo_like_batch of the pair's widths; `valid` keeps that share
    of the large features' ids (the others -1, ignored); `skew` draws
    every large id from the table's first `skew` rows."""
    raw = synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                      multi_hot_sizes=MULTI_HOT, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for i in LARGE:
        ids = raw[f"cat_{i}"]
        if skew is not None:
            ids = ids % skew
        raw[f"cat_{i}"] = np.where(rng.random(ids.shape) < valid, ids, -1)
    return raw


#: Two light batches, a skewed full one that overflows what they grew,
#: then two uniform full ones.
BATCHES = [_batch(1, valid=0.3), _batch(2, valid=0.35),
           _batch(3, skew=7), _batch(4), _batch(5)]


def _capacities(layer) -> list[tuple[int, int]]:
    return [(s.max_ids_per_partition, s.max_unique_ids_per_shard)
            for s in layer.stacks]


#: What one batch can fill at D = 1: all B * 5 large entries in the one
#: bucket, U one slot more. The port's growth stops there; the JAX
#: layer's 1.25 margin may size past it (ROADMAP C4).
MOST = B * 5


def _capped(caps: list[tuple[int, int]]) -> list[tuple[int, int]]:
    return [(min(c, MOST), min(u, MOST + 1)) for c, u in caps]


def _dropped(layer) -> int:
    return sum(st.dropped_ids for st in layer.input_stats.values())


def test_grown_capacities_and_losses_match_jax():
    jmodel, tmodel = build_pair(seed=4, **START, **F32)
    start = _capacities(tmodel.embedding_layer)
    assert start == _capacities(jmodel.embedding_layer) == [(64, 32)]
    seen, jax_seen = [], []
    for raw in BATCHES:
        jmodel.preprocess(dict(raw), training=True)
        tmodel.preprocess(raw, training=True)
        got = _capacities(tmodel.embedding_layer)
        want = _capacities(jmodel.embedding_layer)
        assert got == _capped(want)
        assert _dropped(tmodel.embedding_layer) == 0
        assert _dropped(jmodel.embedding_layer) == 0
        seen.append(got[0])
        jax_seen.append(want[0])
    # Growth at the first batch and at the skewed one, never after; the
    # light batches grow below what a batch can fill, where the two
    # layers agree, and the skewed one to it, where JAX goes past.
    assert seen[0] != start[0] and seen[1] == seen[0]
    assert seen[2] != seen[1] and seen[2] == seen[3] == seen[4]
    assert seen[:2] == jax_seen[:2]
    assert seen[2] == (MOST, MOST + 1) and jax_seen[2][0] > MOST

    opt = optax.adagrad(LR)
    state = jax_training.create_train_state(jmodel, opt)
    jstep = jax_training.make_train_step(jax_dlrm.bce_loss, opt,
                                         donate=False)
    tstep = train_state.make_train_step(
        tmodel, torch_dlrm.bce_loss,
        train_state.DenseAdagrad(tmodel.parameters(), LR))
    j_losses, t_losses = [], []
    for raw in BATCHES[2:]:
        state, loss = jstep(state, state.model.preprocess(dict(raw),
                                                          training=True))
        j_losses.append(float(loss))
        t_losses.append(float(tstep(tmodel.preprocess(raw, training=True))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-5)
    assert len(set(t_losses)) == 3
    assert _capacities(tmodel.embedding_layer) == [seen[-1]]


def test_growth_drops_no_id_and_warns_of_nothing():
    """The first pass of a growing batch overflows quietly (the JAX
    layer suppresses those warnings too); the pass at the grown
    capacities keeps every id."""
    _, tmodel = build_pair(seed=4, **START, **F32)
    with pytest.warns(UserWarning, match="over bucket capacity"):
        tmodel.preprocess(BATCHES[3])  # not training: dropped, warned
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pre = tmodel.preprocess_host(BATCHES[3], training=True)
    (stack,) = tmodel.embedding_layer.stacks
    coo = pre["large_pre"]["sharded"][stack.name]
    n_valid = sum(int((BATCHES[3][f"cat_{i}"] >= 0).sum()) for i in LARGE)
    assert int((coo.send_slots != stack.sink_slot).sum()) == n_valid
    assert int((coo.entry_unique < stack.max_unique_ids_per_shard).sum()
               ) == n_valid
    assert _dropped(tmodel.embedding_layer) == 0


def _one_feature_layer(caps: tuple[int, int]) -> DistributedEmbedding:
    table = TableConfig("t", 100, 8, optimizer="sgd", combiner="sum",
                        placement="sharded", max_ids_per_partition=caps[0],
                        max_unique_ids_per_partition=caps[1])
    return DistributedEmbedding(
        {"f": FeatureConfig("f", table, (16, 4), (16, 8))},
        generator=torch.Generator().manual_seed(0), device="cpu")


def test_growth_stops_at_what_a_batch_can_fill():
    """A (16, 4) feature's batch fills at most 64 entries: a growing pass
    sizes (64, 65) where the JAX rule gives (80, 81), and its activations
    equal those of a layer built at the JAX capacities bit for bit. A
    batch wider than the declared shape raises the bound to its own ids
    and drops nothing."""
    ids = np.arange(16 * 8).reshape(16, 8) % 100
    capped = _one_feature_layer((4, 4))
    capped.preprocess_host({"f": ids[:, :4]}, training=True)
    assert _capacities(capped) == [(64, 65)]
    jax_sized = _one_feature_layer((80, 81))
    tables = {"t": np.random.default_rng(0).standard_normal(
        (100, 8)).astype(np.float32)}
    acts = []
    for layer in (capped, jax_sized):
        layer.set_embedding_tables(tables)
        with torch.no_grad():
            acts.append(layer(layer.preprocess({"f": ids[:, :4]}))["f"])
    assert torch.equal(acts[0], acts[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        capped.preprocess_host({"f": ids}, training=True)
    assert _capacities(capped) == [(128, 129)]
    assert _dropped(capped) == 0


def test_stale_coo_gives_the_same_step_after_a_growth():
    """A COO preprocessed before another batch grew the stack keeps its
    own shapes: the forward, the loss and the updated tables equal those
    of a twin model that never grew."""
    caps = dict(max_ids_per_partition=200, max_unique_ids_per_partition=200)
    _, grown = build_pair(seed=6, **caps, **F32)
    _, twin = build_pair(seed=6, **caps, **F32)
    light = BATCHES[1]  # fits 200 / 200
    pre_g = grown.preprocess(light, training=True)
    pre_t = twin.preprocess(light, training=True)
    before = _capacities(grown.embedding_layer)
    with torch.no_grad():
        acts = grown.embedding_layer(pre_g["large_pre"])
    grown.preprocess(BATCHES[4], training=True)  # 320 ids: grows
    assert _capacities(grown.embedding_layer) != before
    assert _capacities(twin.embedding_layer) == before
    with torch.no_grad():
        after = grown.embedding_layer(pre_g["large_pre"])
    for k in acts:
        assert torch.equal(after[k], acts[k]), k
    losses = []
    for model, pre in ((grown, pre_g), (twin, pre_t)):
        step = train_state.make_train_step(
            model, torch_dlrm.bce_loss,
            train_state.DenseAdagrad(model.parameters(), LR))
        losses.append(float(step(pre)))
    assert losses[0] == losses[1]
    g_tables = grown.embedding_layer.get_embedding_tables()
    t_tables = twin.embedding_layer.get_embedding_tables()
    for name in t_tables:
        assert torch.equal(g_tables[name], t_tables[name]), name


STRESS_THREADS, STRESS_BATCHES, STRESS_VALENCE = 12, 16, 64


def _stress_layer(start: int) -> DistributedEmbedding:
    table = TableConfig("t", 5000, 16, optimizer="sgd", combiner="sum",
                        placement="sharded", max_ids_per_partition=start,
                        max_unique_ids_per_partition=start)
    return DistributedEmbedding(
        {"f": FeatureConfig("f", table, (32, STRESS_VALENCE), (32, 16))},
        generator=torch.Generator().manual_seed(0), device="cpu")


def test_loader_threads_grow_without_dropping(monkeypatch):
    """More threads than cores preprocess batches with `training` under a
    short switch interval, each thread's batches growing (so the threads
    keep growing the capacities at once), with a sleep inside each
    growth (between reading the stacks and replacing them) that hands
    the interpreter to another thread: no pass keeps fewer ids than its
    batch holds, no id is dropped, and the capacities never fall and
    end at or above the largest batch."""
    replace = dataclasses.replace

    def slow_replace(*args, **kwargs):
        time.sleep(1e-3)
        return replace(*args, **kwargs)

    layer = _stress_layer(start=4)
    monkeypatch.setattr(dataclasses, "replace", slow_replace)
    rng = np.random.default_rng(0)
    work_of = []
    for t in range(STRESS_THREADS):
        mine = []
        for j in range(STRESS_BATCHES):
            valid = min(STRESS_VALENCE, 1 + 4 * j + t % 4)
            ids = rng.integers(0, 5000, size=(32, STRESS_VALENCE))
            ids[:, valid:] = -1
            mine.append(ids)
        work_of.append(mine)
    caps = [[] for _ in range(STRESS_THREADS)]
    bad, errors = [], []
    sink = layer.stacks[0].sink_slot
    name = layer.stacks[0].name

    def work(t):
        try:
            for ids in work_of[t]:
                pre = layer.preprocess_host({"f": ids}, training=True)
                kept = int((pre["sharded"][name].send_slots != sink).sum())
                caps[t].append(_capacities(layer)[0])
                if kept != int((ids >= 0).sum()):
                    bad.append((kept, int((ids >= 0).sum())))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(STRESS_THREADS)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert not bad, bad
    assert sum(len(c) for c in caps) == STRESS_THREADS * STRESS_BATCHES
    assert _dropped(layer) == 0
    C, U = _capacities(layer)[0]
    assert C >= 32 * STRESS_VALENCE and U > C
    # Capacities never fall: each thread's readings rise or stay, up to
    # the final ones.
    for mine in caps:
        assert mine == sorted(mine) and all(c <= C and u <= U
                                            for c, u in mine)


def test_mlperf_host_mode_grows_on_four_loader_threads(caplog):
    cfg = configs.smoke_test()
    with caplog.at_level(logging.INFO, logger="ml_perf"):
        r = mlperf.main("smoke_test", device="cpu", num_steps=8,
                        num_loader_threads=4)
    assert np.isfinite(r["loss"])
    large = sum(m for v, m in zip(cfg.vocab_sizes, cfg.multi_hot_sizes)
                if v >= cfg.embedding_threshold)
    assert r["capacities"]
    for got in r["capacities"].values():
        # Every large id of a batch in the one bucket: the first batch
        # overflows the config's capacities and grows them to all it can
        # fill, nothing more (ROADMAP C4).
        assert got["max_ids_per_partition"] == cfg.global_batch_size * large
        assert got["max_unique_ids_per_shard"] == (
            cfg.global_batch_size * large + 1)
        assert got["dropped_ids"] == 0
    logged = [m for m in caplog.messages if m.startswith("stack ")]
    assert len(logged) == len(r["capacities"])
    assert all("'dropped_ids': 0" in m for m in logged)


def test_device_mode_keeps_the_worst_case_capacities():
    r = mlperf.main("smoke_test", device="cpu", num_steps=2,
                    device_preprocessing=True)
    max_ids, max_unique = mlperf.capacities(configs.smoke_test())
    assert list(r["capacities"].values()) == [{
        "max_ids_per_partition": max_ids,
        "max_unique_ids_per_shard": max_unique, "dropped_ids": None}]


def test_jax_model_preprocess_takes_training():
    """The two models' preprocess signatures agree on `training`."""
    import inspect

    for fn in (jax_dlrm.DLRMDCNv2.preprocess,
               torch_dlrm.DLRMDCNv2.preprocess,
               torch_dlrm.DLRMDCNv2.preprocess_host):
        p = inspect.signature(fn).parameters["training"]
        assert p.default is False
    assert jax.devices()  # the JAX side ran on the CPU
