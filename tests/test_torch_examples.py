"""The port's walkthrough examples (keras_rs_tpu_torch/examples/) on the
CPU, and the models they define held to the JAX examples' classes.

Each example runs at a reduced size (fewer epochs and events; one torch
thread) and clears the check of the JAX package's
tests/test_examples.py::test_example_runs: it finishes and prints the
line that test greps for ("NDCG@5", "recall", "recall@10"); its
headline number is finite and in its range.

The example-defined models (multi_task's MultiTaskModel,
deep_recommender's towers, listwise_ranking's item scorer over a
TwoTower) take the JAX example model's parameters
(torch_parity.load_from_jax) and are held to it on one batch: the loss
and, after one Adagrad step, every parameter within 1e-5 (f32; the
packages sum in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity

from examples import deep_recommender as jax_deep
from examples import listwise_ranking as jax_listwise
from examples import multi_task as jax_multi_task
from keras_rs_tpu import losses as jax_losses
from keras_rs_tpu import models as jax_models
from keras_rs_tpu import training as jax_training
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.data.feature_engineering import TextVectorizer
from keras_rs_tpu_torch.examples import (
    basic_ranking,
    basic_retrieval,
    deep_recommender,
    listwise_ranking,
    multi_task,
    sas_rec,
)
from keras_rs_tpu_torch.losses import list_mle_loss, pairwise_losses
from keras_rs_tpu_torch.models.two_tower import TwoTower
from keras_rs_tpu_torch.training import train_state

EXAMPLES = {
    "basic_ranking": (basic_ranking, dict(epochs=2, num_examples=12_000,
                                          num_train=10_000), ""),
    "basic_retrieval": (basic_retrieval, dict(epochs=3, num_events=10_000),
                        "serving export round-trip OK"),
    "listwise_ranking": (listwise_ranking, dict(epochs=3, num_lists=1000),
                         "NDCG@5"),
    "multi_task": (multi_task, dict(epochs=1, num_events=6000),
                   "rating RMSE"),
    "deep_recommender": (deep_recommender, dict(epochs=2, num_events=5000),
                         "recall@10"),
    "sas_rec": (sas_rec, dict(epochs=2, layers=1, dim=32,
                              num_sessions=1536, num_train=1024), "recall"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    module, kw, expect = EXAMPLES[name]
    headline = module.main("cpu", **kw)
    out = capsys.readouterr().out
    assert expect in out, out
    assert math.isfinite(headline)
    if name in ("basic_ranking", "multi_task"):  # RMSE on [0.5, 5]
        assert 0.0 < headline < 5.0
    else:  # recall@10 or NDCG@5
        assert 0.0 <= headline <= 1.0


def _step_pair(jmodel, tmodel, jloss, tloss, jbatch, tbatch, lr):
    """(JAX loss, port loss) of one Adagrad step each, then every
    parameter of the port held to the JAX model's."""
    opt = optax.adagrad(lr)
    state = jax_training.create_train_state(jmodel, opt)
    step = jax_training.make_train_step(jloss, opt, donate=False)
    state, jl = step(state, jbatch)
    tl = train_state.make_train_step(
        tmodel, tloss, train_state.DenseAdagrad(tmodel.parameters(), lr))(
        tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(),
            np.asarray(torch_parity.jax_attr(state.model, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)


def _events(n=256, users=300, items=300, seed=0):
    fb = synthetic.implicit_feedback(num_users=users, num_items=items,
                                     num_events=n, holdout_per_user=1,
                                     seed=seed, with_ratings=True)
    return {k: fb[k] for k in ("user_id", "item_id", "rating")}


@pytest.mark.parametrize("weights", sorted(multi_task.SWEEP.values()))
def test_multi_task_model_matches_jax(weights):
    jmodel = jax_multi_task.MultiTaskModel(300, 300, 32, jax.random.key(5))
    tmodel = torch_parity.load_from_jax(
        multi_task.MultiTaskModel(300, 300, 32, device="cpu"), jmodel)
    ev = _events()
    jbatch = {k: jnp.asarray(v) for k, v in ev.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in ev.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            tmodel.rating(tbatch["user_id"], tbatch["item_id"]).numpy(),
            np.asarray(jmodel.rating(jbatch["user_id"], jbatch["item_id"])),
            rtol=1e-5, atol=1e-6)
    _step_pair(jmodel, tmodel, jax_multi_task.make_loss(*weights),
               multi_task.make_loss(*weights), jbatch, tbatch, 0.1)


def _jax_deep_loss(m, batch):
    """The JAX example's loss (defined inside its main)."""
    q = m.query(batch["user_id"], batch["age_bucket"], batch["cross"])
    c = m.candidate(batch["item_id"], batch["genres"], batch["genre_w"],
                    batch["title_ids"], batch["title_w"])
    logp = jax.nn.log_softmax(q @ c.T, -1)
    return -jnp.mean(jnp.diagonal(logp))


def test_deep_recommender_towers_match_jax():
    titles = [f"the {w} {v}" for w in ("lion", "space", "war", "king")
              for v in ("night", "city", "dream")]
    tv = TextVectorizer(output_sequence_length=4).adapt(titles)
    title_ids, title_w = tv(titles)
    jmodel = jax_deep.DeepRecommender(400, 12, 12, tv.vocabulary_size, 32,
                                      jax.random.key(2))
    tmodel = torch_parity.load_from_jax(
        deep_recommender.DeepRecommender(400, 12, 12, tv.vocabulary_size,
                                         32, device="cpu"), jmodel)
    rng = np.random.default_rng(3)
    n = 128
    users = rng.integers(0, 400, n).astype(np.int32)
    items = rng.integers(0, 12, n).astype(np.int32)
    ages = deep_recommender.bucketize(rng.uniform(18, 80, n),
                                      deep_recommender.AGE_BOUNDARIES)
    genres = rng.integers(0, 12, (12, 3)).astype(np.int32)
    genre_w = rng.uniform(0.5, 1.5, (12, 3)).astype(np.float32)
    batch = {
        "user_id": users, "age_bucket": ages,
        "cross": deep_recommender.hash_cross([users, ages],
                                             deep_recommender.CROSS_BINS),
        "item_id": items, "genres": genres[items], "genre_w": genre_w[items],
        "title_ids": title_ids[items], "title_w": title_w[items],
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            tmodel.query(tbatch["user_id"], tbatch["age_bucket"],
                         tbatch["cross"]).numpy(),
            np.asarray(jmodel.query(jbatch["user_id"], jbatch["age_bucket"],
                                    jbatch["cross"])),
            rtol=1e-5, atol=1e-6)
    _step_pair(jmodel, tmodel, _jax_deep_loss, deep_recommender.loss_fn,
               jbatch, tbatch, 0.2)


LISTWISE = {
    "pointwise MSE": (None, None),
    "pairwise MSE": (jax_losses.PairwiseMeanSquaredError,
                     pairwise_losses.PairwiseMeanSquaredError),
    "pairwise hinge": (jax_losses.PairwiseHingeLoss,
                       pairwise_losses.PairwiseHingeLoss),
    "pairwise logistic": (jax_losses.PairwiseLogisticLoss,
                          pairwise_losses.PairwiseLogisticLoss),
    "ListMLE": (jax_losses.ListMLELoss, list_mle_loss.ListMLELoss),
}


def _jax_listwise_loss(loss_obj):
    def loss_fn(m, batch):
        u, it, y = batch
        scores = jax_listwise.item_scores(m, u, it)
        if loss_obj is None:
            return jnp.mean((scores - y) ** 2)
        return loss_obj(y_true=y, y_pred=scores)
    return loss_fn


@pytest.mark.parametrize("objective", sorted(LISTWISE))
def test_listwise_scorer_matches_jax(objective):
    jcls, tcls = LISTWISE[objective]
    jmodel = jax_models.TwoTower(200, 100, 16, key=jax.random.key(1))
    tmodel = TwoTower(200, 100, 16, device="cpu")
    convert.load_params(tmodel, torch_parity.jax_two_tower_params(jmodel))
    users, items, labels = listwise_ranking.make_lists(num_lists=256,
                                                       seed=4)
    jbatch = tuple(jnp.asarray(a) for a in (users, items, labels))
    tbatch = tuple(torch.from_numpy(a) for a in (users, items, labels))
    with torch.no_grad():
        np.testing.assert_allclose(
            listwise_ranking.item_scores(tmodel, *tbatch[:2]).numpy(),
            np.asarray(jax_listwise.item_scores(jmodel, *jbatch[:2])),
            rtol=1e-5, atol=1e-6)
    _step_pair(jmodel, tmodel,
               _jax_listwise_loss(jcls() if jcls else None),
               listwise_ranking.make_loss(tcls() if tcls else None,
                                          pointwise=tcls is None),
               jbatch, tbatch, 0.3)
