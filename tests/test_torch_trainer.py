"""The port's Trainer (training/trainer.py: fit with validation,
checkpoints, metrics log, prefetch and profiling; evaluate) and its
checkpoints (training/checkpoint.py) against the JAX package's, on the
CPU, from identical parameters and numpy batches.

Tolerances: fit's losses and validation values within 1e-5 relative of
the JAX Trainer's (f32, a few Adagrad steps); evaluate's metrics and
weighted loss within 1e-6; a run resumed from a checkpoint against the
run that went on in memory: exactly equal losses (the CPU sums in one
order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity

from keras_rs_tpu import training as jtraining
from keras_rs_tpu.metrics import ranking_metrics as jmetrics
from keras_rs_tpu.models import two_tower as jtwo_tower
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.metrics import ranking_metrics
from keras_rs_tpu_torch.models.two_tower import TwoTower
from keras_rs_tpu_torch.training import checkpoint, train_state
from keras_rs_tpu_torch.training.trainer import Trainer, prefetch_to_device

U, I, D = 50, 40, 8


def _two_tower_pair(seed=0):
    jmodel = jtwo_tower.TwoTower(U, I, D, key=jax.random.key(seed))
    tmodel = TwoTower(U, I, D, device="cpu")
    convert.load_params(tmodel, torch_parity.jax_two_tower_params(jmodel))
    return jmodel, tmodel


def _ids():
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, 512).astype(np.int64)
    return u, ((u * 7) % I).astype(np.int64)


def _softmax_loss(lib):
    def loss_fn(m, batch):
        uu, ii = batch
        scores = m.query_tower(uu) @ m.candidate_tower(ii).T
        if lib == "jax":
            logp = jax.nn.log_softmax(scores, -1)
            return -jnp.mean(jnp.diagonal(logp))
        return -torch.log_softmax(scores, -1).diagonal().mean()
    return loss_fn


def test_fit_validation_checkpoints_and_metrics_log(tmp_path):
    """JAX tests/test_training.py::test_trainer_fit_validation_best_checkpoint
    on both packages: the same losses and validation values; `last`,
    `best` and one JSONL record per epoch; `best` restores."""
    u, it = _ids()
    jmodel, tmodel = _two_tower_pair()

    def data(to):
        def gen():
            for i in range(0, 512, 128):
                yield to(u[i:i + 128]), to(it[i:i + 128])
        return gen

    def jval(m):
        q, c = m.query_tower(jnp.asarray(u)), m.candidate_tower(
            jnp.asarray(it))
        return float(-jnp.mean(jnp.sum(q * c, axis=-1)))

    vals = []

    def tval(m):
        with torch.no_grad():
            q = m.query_tower(torch.from_numpy(u))
            c = m.candidate_tower(torch.from_numpy(it))
            vals.append(float(-(q * c).sum(-1).mean()))
            return vals[-1]

    jhist = jtraining.Trainer(jmodel, optax.adagrad(0.5),
                              _softmax_loss("jax")).fit(
        data(jnp.asarray), epochs=3, log_every=0, validation_fn=jval)
    log = tmp_path / "metrics.jsonl"
    trainer = Trainer(tmodel, train_state.DenseAdagrad(tmodel.parameters(),
                                                       0.5),
                      _softmax_loss("torch"))
    hist = trainer.fit(data(torch.from_numpy), epochs=3, log_every=0,
                       prefetch=2, validation_fn=tval,
                       checkpoint_dir=str(tmp_path / "ck"),
                       metrics_log=str(log))
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(hist["val"], jhist["val"], rtol=1e-5)
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1, 2]
    assert [r["val"] for r in lines] == hist["val"]
    assert [r["loss"] for r in lines] == hist["loss"]
    assert sorted(os.listdir(tmp_path / "ck")) == ["best", "last"]
    best_epoch = int(np.argmin(hist["val"]))
    fresh = TwoTower(U, I, D, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    restored = Trainer(fresh, train_state.DenseAdagrad(fresh.parameters(),
                                                       0.5),
                       _softmax_loss("torch"))
    checkpoint.restore_checkpoint(str(tmp_path / "ck" / "best"),
                                  restored.state)
    assert tval(fresh) == hist["val"][best_epoch]
    checkpoint.restore_checkpoint(str(tmp_path / "ck" / "last"),
                                  restored.state)
    for (n, a), (_, b) in zip(fresh.named_parameters(),
                              tmodel.named_parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(restored.optimizer.accumulators,
                    trainer.optimizer.accumulators):
        assert torch.equal(a, b)


def _layer(seed):
    table = TableConfig(
        name="t", vocabulary_size=211, embedding_dim=8, combiner="mean",
        placement="sharded", optimizer="adam",
        max_ids_per_partition=64, max_unique_ids_per_partition=64)
    fc = FeatureConfig(name="f", table=table, input_shape=(16, 3),
                       output_shape=(16, 8))
    return DistributedEmbedding({"f": fc}, device="cpu",
                                generator=torch.Generator().manual_seed(seed))


def _two_table_layer(first: str, seed: int = 0):
    """Tables "a" and "b" in one stack; dict keys sort, so the feature
    that reads `first` stacks its table first."""
    tables = {n: TableConfig(
        name=n, vocabulary_size=97, embedding_dim=8, placement="sharded",
        optimizer="adagrad", max_ids_per_partition=64,
        max_unique_ids_per_partition=64) for n in ("a", "b")}
    second = "b" if first == "a" else "a"
    fcs = {k: FeatureConfig(name=k, table=tables[t], input_shape=(16, 2),
                            output_shape=(16, 8))
           for k, t in (("f0", first), ("f1", second))}
    return DistributedEmbedding(fcs, device="cpu",
                                generator=torch.Generator().manual_seed(seed))


def test_checkpoint_of_another_stack_layout_is_refused(tmp_path):
    """A stack's table order is part of its state: a checkpoint whose
    stacks hold the tables in another order, or that names no layout,
    raises instead of restoring rows into the wrong tables."""
    path = str(tmp_path / "ckpt")
    layer = _two_table_layer("a")
    assert [t.name for t in layer.stacks[0].tables] == ["a", "b"]
    checkpoint.save_checkpoint(path, layer)
    same = checkpoint.restore_checkpoint(path, _two_table_layer("a", seed=3))
    for k, v in layer.state_dict().items():
        assert torch.equal(v, same.state_dict()[k]), k
    swapped = _two_table_layer("b", seed=3)
    assert [t.name for t in swapped.stacks[0].tables] == ["b", "a"]
    before = swapped.stack_state(0)["table"].clone()
    with pytest.raises(ValueError, match="another stack layout"):
        checkpoint.restore_checkpoint(path, swapped)
    assert torch.equal(swapped.stack_state(0)["table"], before)
    old = {k: v for k, v in layer.state_dict().items()
           if not k.endswith("_layout")}
    torch.save(old, path)
    with pytest.raises(ValueError, match="another stack layout"):
        checkpoint.restore_checkpoint(path, _two_table_layer("a"))


def test_checkpoint_resume_continuity_with_embedding_slots(tmp_path):
    """JAX tests/test_training.py::test_checkpoint_resume_training_
    continuity: 5 steps, checkpoint, 5 more in memory vs restored into a
    layer drawn from another seed; the Adam slots and the step counter
    travel with the model's state_dict."""
    rng = np.random.default_rng(0)
    batches = [{"ids": torch.from_numpy(rng.integers(0, 211, (16, 3))),
                "y": torch.from_numpy(
                    rng.normal(size=(16, 8)).astype(np.float32))}
               for _ in range(10)]

    def loss_fn(m, b):
        acts = m(m.preprocess_on_device({"f": b["ids"]}))["f"]
        return torch.mean((acts - b["y"]) ** 2)

    def steps(layer, bs):
        opt = train_state.DenseAdam(list(layer.parameters()), 0.05)
        step = train_state.make_train_step(layer, loss_fn, opt)
        return [float(step(b)) for b in bs]

    layer = _layer(0)
    assert not layer.stacks[0].packed_state  # Adam: split slots
    steps(layer, batches[:5])
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, layer)
    losses_a = steps(layer, batches[5:])
    fresh = _layer(7)
    checkpoint.restore_checkpoint(path, fresh)
    assert float(fresh.stack_state(0)["step"]) == 5.0
    losses_b = steps(fresh, batches[5:])
    assert losses_a == losses_b
    assert float(fresh.stack_state(0)["step"]) == 10.0
    for k, v in layer.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    with pytest.raises(FileExistsError):
        checkpoint.save_checkpoint(path, layer, force=False)
    assert os.listdir(tmp_path) == ["ckpt"]  # no temporary file left


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    layer = _layer(0)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(None, layer)
    saved = {}
    for step in (2, 4, 6):
        with torch.no_grad():
            layer.stack_state(0)["table"].add_(1.0)
        mgr.save(step, layer)
        saved[step] = layer.stack_state(0)["table"].clone()
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    fresh = _layer(3)
    mgr.restore(4, fresh)
    assert torch.equal(fresh.stack_state(0)["table"], saved[4])
    mgr.restore(None, fresh)
    assert torch.equal(fresh.stack_state(0)["table"], saved[6])
    mgr.close()


def _eval_batches(u, it, sizes=(96, 160, 64)):
    out, start = [], 0
    for n in sizes:
        out.append((u[start:start + n], it[start:start + n]))
        start += n
    return out


@pytest.mark.parametrize("report_loss", [True, False])
def test_evaluate_matches_jax(report_loss):
    """Recall@5, NDCG@5 and MRR over the whole candidate set, and the
    training loss weighted by each batch's rows (uneven batches)."""
    u, it = _ids()
    jmodel, tmodel = _two_tower_pair(seed=3)
    batches = _eval_batches(u, it)

    def metrics(mod, **kw):
        return {"recall": mod.RecallAtK(5, **kw), "ndcg": mod.NDCG(5, **kw),
                "mrr": mod.MeanReciprocalRank(**kw)}

    def jeval(m, batch):
        uu, ii = batch
        scores = m.query_tower(uu) @ m.candidate_tower(jnp.arange(I)).T
        return jax.nn.one_hot(ii, I), scores

    def teval(m, batch):
        uu, ii = batch
        scores = m.query_tower(uu) @ m.candidate_tower(torch.arange(I)).T
        return torch.nn.functional.one_hot(ii, I).float(), scores

    jres = jtraining.Trainer(jmodel, optax.adagrad(0.1),
                             _softmax_loss("jax")).evaluate(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches],
        metrics(jmetrics), jeval, report_loss=report_loss)
    trainer = Trainer(tmodel, train_state.DenseAdagrad(tmodel.parameters(),
                                                       0.1),
                      _softmax_loss("torch"))
    res = trainer.evaluate(batches, metrics(ranking_metrics, device="cpu"),
                           teval, report_loss=report_loss)
    assert set(res) == set(jres)
    assert ("loss" in res) == report_loss
    for k in res:
        np.testing.assert_allclose(res[k], jres[k], rtol=1e-6, err_msg=k)
        assert k == "loss" or 0.0 <= res[k] <= 1.0


def test_evaluate_default_eval_fn_and_empty_data():
    model = torch.nn.Linear(3, 1)
    trainer = Trainer(model, train_state.DenseAdam(model.parameters(), 0.1),
                      lambda m, b: ((m(b[0])[:, 0] - b[1]) ** 2).mean())

    class MSE:
        def init_state(self):
            return torch.zeros(2)

        def update(self, state, y, p, w=None):
            return state + torch.stack([((p[:, 0] - y) ** 2).sum(),
                                        torch.tensor(float(len(y)))])

        def result_from_state(self, state):
            return state[0] / state[1]

    x = np.random.default_rng(1).standard_normal((10, 3)).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    res = trainer.evaluate([(x[:4], y[:4]), (x[4:], y[4:])], {"mse": MSE()})
    np.testing.assert_allclose(res["mse"], res["loss"], rtol=1e-6)
    with pytest.raises(ValueError, match="empty dataset"):
        trainer.evaluate([], {"mse": MSE()})
    with pytest.raises(ValueError, match="no batches"):
        trainer.fit([], epochs=1)


def test_prefetch_to_device_on_the_cpu_passes_batches_through():
    batches = [{"a": np.arange(i, i + 3), "b": (np.ones(2) * i, [i])}
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert g is b


def test_fit_profile_dir_writes_a_trace(tmp_path):
    u, it = _ids()
    _, tmodel = _two_tower_pair()
    trainer = Trainer(tmodel, train_state.DenseAdagrad(tmodel.parameters(),
                                                       0.5),
                      _softmax_loss("torch"))
    batches = [(u[i:i + 64], it[i:i + 64]) for i in range(0, 320, 64)]
    trainer.fit(batches, log_every=0, profile_dir=str(tmp_path / "prof"),
                profile_steps=(1, 2))
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / traces[0]) > 0
    # A run that ends inside the window still writes its trace.
    trainer.fit(batches[:2], log_every=0, profile_dir=str(tmp_path / "p2"),
                profile_steps=(1, 5))
    assert len(os.listdir(tmp_path / "p2")) == 1


def _aux_loss(lib):
    """_softmax_loss with an aux: the mean query norm and a tuple."""
    base = _softmax_loss(lib)

    def loss_fn(m, batch):
        loss = base(m, batch)
        q = m.query_tower(batch[0])
        return loss, {"norm": (q * q).sum(-1).mean(),
                      "pair": (2 * loss, loss + 1)}
    return loss_fn


def _aux_leaves(aux):
    return [aux["norm"], aux["pair"][0], aux["pair"][1]]


@pytest.mark.parametrize("entry", ["step", "fit", "evaluate"])
def test_has_aux_matches_jax(entry):
    """has_aux in make_train_step, Trainer.fit and Trainer.evaluate
    against the JAX Trainer(has_aux=True): the step returns (loss, aux)
    detached, in the loss function's structure; fit and evaluate read
    the loss from out[0]. Within 1e-5 relative (f32 Adagrad steps), and
    the losses equal those of the same loss without an aux."""
    u, it = _ids()
    jmodel, tmodel = _two_tower_pair(seed=4)
    _, plain = _two_tower_pair(seed=4)
    batches = [(u[i:i + 128], it[i:i + 128]) for i in range(0, 512, 128)]
    jbatches = [(jnp.asarray(a), jnp.asarray(b)) for a, b in batches]
    tbatches = [(torch.from_numpy(a), torch.from_numpy(b))
                for a, b in batches]
    jtrainer = jtraining.Trainer(jmodel, optax.adagrad(0.5),
                                 _aux_loss("jax"), has_aux=True)
    trainer = Trainer(tmodel, train_state.DenseAdagrad(tmodel.parameters(),
                                                       0.5),
                      _aux_loss("torch"), has_aux=True)
    reference = Trainer(plain, train_state.DenseAdagrad(plain.parameters(),
                                                        0.5),
                        _softmax_loss("torch"))
    if entry == "step":
        jstep = jtraining.make_train_step(_aux_loss("jax"),
                                          optax.adagrad(0.5), has_aux=True,
                                          donate=False)
        jstate = jtraining.create_train_state(jmodel, optax.adagrad(0.5))
        for jb, tb in zip(jbatches, tbatches):
            jstate, (jloss, jaux) = jstep(jstate, *[jb])
            loss, aux = trainer.step(tb)
            assert float(loss) == float(reference.step(tb))
            assert not loss.requires_grad
            assert isinstance(aux["pair"], tuple)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            for got, want in zip(_aux_leaves(aux), _aux_leaves(jaux)):
                assert not got.requires_grad
                np.testing.assert_allclose(float(got), float(want),
                                           rtol=1e-5)
    elif entry == "fit":
        jhist = jtrainer.fit(lambda: iter(jbatches), epochs=2, log_every=0)
        hist = trainer.fit(lambda: iter(tbatches), epochs=2, log_every=1)
        np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
        assert hist == reference.fit(lambda: iter(tbatches), epochs=2,
                                     log_every=0)
    else:
        jres = jtrainer.evaluate(jbatches, {}, lambda m, b: (b[1], b[1]))
        res = trainer.evaluate(tbatches, {}, lambda m, b: (b[1], b[1]))
        np.testing.assert_allclose(res["loss"], jres["loss"], rtol=1e-6)
        assert res == reference.evaluate(tbatches, {},
                                         lambda m, b: (b[1], b[1]))
