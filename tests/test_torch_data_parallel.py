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

The JAX run takes its ~160 collective programs on the 8-device mesh in a
subprocess, retried on XLA's CPU collective-rendezvous abort (a loaded
machine can starve a collective's participant threads past the CPU
backend's 40 s termination timeout, and XLA ends the process with
"Termination timeout for ... exceeded", the only failure retried;
tests/test_examples.py's `run_example` retries the JAX example the same
way). The run is deterministic, so any attempt gives the reference; a
failure without the marker is reported on the first attempt.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

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


TESTS = Path(__file__).resolve().parent
JAX_ATTEMPTS = 3
#: XLA's message when it ends a process whose collective rendezvous
#: waited past the termination timeout (xla/service/rendezvous.cc).
RENDEZVOUS_ABORT = re.compile(r"Termination timeout for .* exceeded")
_JAX_RUN = """
import sys
import numpy as np
import test_torch_data_parallel as t
params, losses = t._jax_data_parallel(t.EPOCHS)
np.savez(sys.argv[1], losses=np.asarray(losses, np.float64),
         **{"p/" + k: v for k, v in params.items()})
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """`_jax_data_parallel(EPOCHS)` in a subprocess on the 8-device CPU
    mesh (see the module docstring): (params, losses)."""
    out = tmp_path_factory.mktemp("jax_data_parallel") / "run.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent), str(TESTS)]),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for attempt in range(1, JAX_ATTEMPTS + 1):
        r = subprocess.run([sys.executable, "-c", _JAX_RUN, str(out)],
                           cwd=TESTS.parent, env=env, capture_output=True,
                           text=True, timeout=600)
        if r.returncode == 0 or not RENDEZVOUS_ABORT.search(r.stderr):
            break
    assert r.returncode == 0, (
        f"attempt {attempt} of {JAX_ATTEMPTS}, each before it ended by "
        f"XLA's rendezvous abort:\n{r.stderr[-3000:]}")
    with np.load(out) as z:
        params = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
        return params, list(z["losses"])


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
