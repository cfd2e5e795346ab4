"""The port's TwoTower and BasicRanking (models/two_tower.py,
models/ranking_model.py) against the JAX package's, on the CPU:
parameters carried across by convert.load_params, the towers' scores,
`in_batch_softmax_loss` with and without sampling probabilities, 3
training steps of the port's Trainer + DenseAdagrad against the JAX
Trainer + optax.adagrad, and `make_retrieval`'s ids. f32 within 1e-5."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity

from keras_rs_tpu import training as jtraining
from keras_rs_tpu.models import ranking_model as jranking_model
from keras_rs_tpu.models import two_tower as jtwo_tower
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.metrics import ranking_metrics
from keras_rs_tpu_torch.layers.retrieval import kmeans_retrieval
from keras_rs_tpu_torch.models import ranking_model, two_tower
from keras_rs_tpu_torch.training import train_state
from keras_rs_tpu_torch.training.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
QUERIES, CANDIDATES, DIM, B = 60, 45, 8, 16
TOWERS = {"embeddings": (), "mlp": (16, 8)}


def _pair(towers, seed=0):
    jmodel = jtwo_tower.TwoTower(QUERIES, CANDIDATES, DIM,
                                 key=jax.random.key(seed),
                                 tower_units=TOWERS[towers])
    tmodel = two_tower.TwoTower(QUERIES, CANDIDATES, DIM,
                                tower_units=TOWERS[towers], device="cpu")
    convert.load_params(tmodel, torch_parity.jax_two_tower_params(jmodel))
    return jmodel, tmodel


def _batch(seed):
    """Query and candidate ids (repeated candidates, as a popular item
    appears twice in a batch) and the batch's sampling probabilities."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, QUERIES, size=B).astype(np.int32)
    c = rng.integers(0, CANDIDATES // 3, size=B).astype(np.int32)
    _, inverse, counts = np.unique(c, return_inverse=True,
                                   return_counts=True)
    p = (counts[inverse] / B).astype(np.float32)
    return {"query_id": q, "candidate_id": c, "sampling_probability": p}


@pytest.mark.parametrize("towers", sorted(TOWERS))
def test_scores_match_jax(towers):
    jmodel, tmodel = _pair(towers)
    b = _batch(1)
    q, c = b["query_id"], b["candidate_id"]
    np.testing.assert_allclose(
        tmodel.in_batch_scores(torch.from_numpy(q),
                               torch.from_numpy(c)).detach().numpy(),
        np.asarray(jmodel.in_batch_scores(jnp.asarray(q), jnp.asarray(c))),
        **TOL)
    np.testing.assert_allclose(
        tmodel(torch.from_numpy(q), torch.from_numpy(c)).detach().numpy(),
        np.asarray(jmodel(jnp.asarray(q), jnp.asarray(c))), **TOL)


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("towers", sorted(TOWERS))
def test_in_batch_softmax_loss_and_gradients_match_jax(towers, corrected):
    jmodel, tmodel = _pair(towers, seed=1)
    b = _batch(2)
    p = b["sampling_probability"] if corrected else None

    def jloss(m):
        return jtwo_tower.in_batch_softmax_loss(
            m, jnp.asarray(b["query_id"]), jnp.asarray(b["candidate_id"]),
            None if p is None else jnp.asarray(p))

    want, grads = jax.value_and_grad(
        lambda e: jloss(_with_query_table(jmodel, e)))(
        jmodel.query_embedding.embeddings)
    got = two_tower.in_batch_softmax_loss(
        tmodel, torch.from_numpy(b["query_id"]),
        torch.from_numpy(b["candidate_id"]),
        None if p is None else torch.from_numpy(p))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(
        tmodel.query_embedding.embeddings.grad.numpy(), np.asarray(grads),
        **TOL)


def _with_query_table(jmodel, table):
    import copy

    m = copy.copy(jmodel)
    m.query_embedding = copy.copy(jmodel.query_embedding)
    m.query_embedding.embeddings = table
    return m


def _loss_fns():
    def jloss(m, batch):
        return jtwo_tower.in_batch_softmax_loss(
            m, batch["query_id"], batch["candidate_id"],
            batch["sampling_probability"])

    def tloss(m, batch):
        return two_tower.in_batch_softmax_loss(
            m, batch["query_id"], batch["candidate_id"],
            batch["sampling_probability"])

    return jloss, tloss


def _fit_both(jmodel, tmodel, jloss, tloss, batches, lr):
    def data(to):
        counter = itertools.count()
        return lambda: iter([to(batches[next(counter)])])

    jtrainer = jtraining.Trainer(jmodel, optax.adagrad(lr), jloss)
    jhist = jtrainer.fit(
        data(lambda b: {k: jnp.asarray(v) for k, v in b.items()}),
        epochs=len(batches), log_every=0)
    ttrainer = Trainer(tmodel, train_state.DenseAdagrad(tmodel.parameters(),
                                                        lr), tloss)
    thist = ttrainer.fit(data(lambda b: b), epochs=len(batches), log_every=0)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], **TOL)
    return jtrainer.model


@pytest.mark.parametrize("towers", sorted(TOWERS))
def test_three_adagrad_steps_match_jax_trainer(towers):
    jmodel, tmodel = _pair(towers, seed=2)
    jtrained = _fit_both(jmodel, tmodel, *_loss_fns(),
                         [_batch(10 + s) for s in range(3)], 0.2)
    want = torch_parity.jax_two_tower_params(jtrained)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **TOL)
    # Serving from the trained towers: the same ids.
    queries = np.arange(0, QUERIES, 7, dtype=np.int32)
    js, ji = jtrained.make_retrieval(k=5)(
        jtrained.query_tower(jnp.asarray(queries)))
    tr = tmodel.make_retrieval(k=5)
    assert not tr.candidate_embeddings.requires_grad
    ts, ti = tr(tmodel.query_tower(torch.from_numpy(queries)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **TOL)


def test_make_retrieval_with_candidate_ids():
    jmodel, tmodel = _pair("mlp", seed=3)
    ids = (np.arange(CANDIDATES) + 1000).astype(np.int32)
    queries = np.arange(5, dtype=np.int32)
    _, ji = jmodel.make_retrieval(k=4, candidate_ids=jnp.asarray(ids))(
        jmodel.query_tower(jnp.asarray(queries)))
    _, ti = tmodel.make_retrieval(k=4, candidate_ids=torch.from_numpy(ids))(
        tmodel.query_tower(torch.from_numpy(queries)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _ranking_pair(seed=0):
    jmodel = jranking_model.BasicRanking(30, 40, embedding_dim=8,
                                         hidden_units=(16, 8, 1),
                                         key=jax.random.key(seed))
    tmodel = ranking_model.BasicRanking(30, 40, embedding_dim=8,
                                        hidden_units=(16, 8, 1),
                                        device="cpu")
    convert.load_params(tmodel,
                        torch_parity.jax_basic_ranking_params(jmodel))
    return jmodel, tmodel


def _ratings(seed):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, 30, size=B).astype(np.int32),
            "item_id": rng.integers(0, 40, size=B).astype(np.int32),
            "rating": rng.uniform(1, 5, size=B).astype(np.float32)}


def test_basic_ranking_forward_and_three_steps_match_jax():
    jmodel, tmodel = _ranking_pair()
    b = _ratings(0)
    np.testing.assert_allclose(
        tmodel(torch.from_numpy(b["user_id"]),
               torch.from_numpy(b["item_id"])).detach().numpy(),
        np.asarray(jmodel(jnp.asarray(b["user_id"]),
                          jnp.asarray(b["item_id"]))), **TOL)
    jtrained = _fit_both(jmodel, tmodel, jranking_model.mse_loss,
                         ranking_model.mse_loss,
                         [_ratings(5 + s) for s in range(3)], 0.1)
    want = torch_parity.jax_basic_ranking_params(jtrained)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("build", [
    lambda **kw: ranking_metrics.NDCG(**kw),
    lambda **kw: kmeans_retrieval.KMeansRetrieval(**kw),
], ids=["NDCG", "KMeansRetrieval"])
def test_state_lives_on_the_card_by_default(build, monkeypatch):
    """The metric's state and the IVF index: cuda:0 unless `device` is
    given, and no fallback (the models: tests/test_torch_device.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    assert build(device="cpu").device == torch.device("cpu")
