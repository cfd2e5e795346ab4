"""Data-parallel training and the multi-rank walkthroughs of the port on
gloo CPU ranks (tests/torch_dist_workers.py), held to the JAX package's
on its virtual CPU mesh: Trainer(mesh=) with prefetch_sharding through
examples/data_parallel_retrieval.py, examples/ann_retrieval.py's
engines, and parallel/dryrun.dryrun_multichip at four ranks.

Bounds:
  * the data-parallel two-tower run from the JAX example's initial
    weights: the loss of each epoch within 1e-5 of the JAX Trainer's on
    its 8-device mesh (the global in-batch softmax: every query against
    all B candidates); prefetch_sharding and put_batch give the same
    run, and the replicas stay equal on every rank (bit for bit);
  * the retrieval shoot-out at its 100,000 x 64 size: the exact engines'
    ids (brute force, chunked, sharded over the ranks) equal the JAX
    brute force's;
  * dryrun_multichip(4): its own bounds (the JAX dry run's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch_dist_workers as workers
from torch_parity import jax_two_tower_params

from keras_rs_tpu import models as jax_models
from keras_rs_tpu import training as jax_training
from keras_rs_tpu.data import synthetic as jsynthetic
from keras_rs_tpu.layers.retrieval.retrieval import (
    BruteForceRetrieval as JaxBruteForce,
)
from keras_rs_tpu.parallel import mesh as jmesh

EPOCHS = 2


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def _jax_data_parallel(epochs):
    """examples/data_parallel_retrieval.py's run for `epochs` epochs:
    (initial params by the port's names, the loss of each epoch)."""
    mesh = jmesh.create_mesh()
    fb = jsynthetic.implicit_feedback(num_users=512, num_items=512,
                                      num_events=40_960, seed=0)
    model = jax_models.TwoTower(512, 512, embedding_dim=32,
                                key=jax.random.key(0))
    params = jax_two_tower_params(model)
    model = jmesh.replicate(mesh, model)

    def loss_fn(m, batch):
        return jax_models.in_batch_softmax_loss(m, batch["user_id"],
                                                batch["item_id"])

    trainer = jax_training.Trainer(model, optax.adagrad(0.5), loss_fn)

    def data():
        for b in jsynthetic.batches({"user_id": fb["user_id"],
                                     "item_id": fb["item_id"]}, 512, seed=1):
            yield jmesh.put_batch(mesh, b)

    return params, trainer.fit(data, epochs=epochs, log_every=0)["loss"]


@pytest.fixture(scope="module")
def jax_run():
    return _jax_data_parallel(EPOCHS)


@pytest.mark.parametrize("D", [2, 4])
def test_data_parallel_retrieval_matches_jax(ranks, jax_run, D):
    params, j_losses = jax_run
    got = ranks(D).run("data_parallel_case", params=params, epochs=EPOCHS)
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["example"]["loss"], j_losses,
                                   rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        assert out["put_batch_loss"] == out["example"]["loss"]
        assert 0.0 < out["example"]["recall"] <= 1.0
    for out in got[1:]:
        np.testing.assert_array_equal(out["kernel"], got[0]["kernel"])


def test_ann_retrieval_exact_engines_match_jax(ranks):
    rng = np.random.default_rng(0)
    cands = rng.normal(size=(100_000, 64)).astype(np.float32)
    queries = rng.normal(size=(256, 64)).astype(np.float32)
    _, want = JaxBruteForce(jnp.asarray(cands), k=10, chunk_size=None)(
        jnp.asarray(queries))
    want = np.asarray(want)
    for out in ranks(2).run("ann_case", num_candidates=100_000,
                            timeout=240):
        assert sorted(out) == sorted([
            "brute force", "chunked exact", "chunked approx", "kmeans-IVF",
            "IVF int8+reorder", "sharded exact x2"])
        for name in ("brute force", "chunked exact", "chunked approx",
                     "sharded exact x2"):
            np.testing.assert_array_equal(out[name]["ids"], want,
                                          err_msg=name)
            assert out[name]["recall"] == 1.0
        for name in ("kmeans-IVF", "IVF int8+reorder"):
            assert 0.0 < out[name]["recall"] <= 1.0


def test_dryrun_multichip_at_four_ranks(ranks):
    got = ranks(4).run("dryrun_case", timeout=240)
    assert len({tuple(sorted(o.items())) for o in got}) == 1
    out = got[0]
    assert abs(out["loss_n"] - out["loss_one"]) < 1e-4
    assert abs(out["loss_2d"] - out["loss_one"]) < 1e-4
