"""The port's SASRec (models/sasrec.py), its Adam and Trainer, and
`markov_sessions` against the JAX package's, from identical parameters
and numpy inputs, on the CPU.

Batches are left-padded as the SASRec slice pads them: some rows keep
only their last few items behind id 0. Their padded query positions see
no real key, the rows where the fused attention's kernels and plain
versions differ; SASRec zeroes them after every block, so states, loss
and gradients agree end to end. f32 throughout: bound 1e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity

from keras_rs_tpu import training as jtraining
from keras_rs_tpu.data import synthetic as jsynthetic
from keras_rs_tpu.models import sasrec as jsasrec
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.models import sasrec
from keras_rs_tpu_torch.training import train_state
from keras_rs_tpu_torch.training.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
ITEMS, T, BATCH = 60, 24, 6
EPS = 1e-5  # Adam's eps in the 3-step comparison (see its docstring)
WIDTHS = dict(num_layers=2, num_heads=2, hidden_dim=16,
              max_sequence_length=T)


def _batch(seed):
    """Markov sessions; rows 0 and 3 cut to 5 and 16 items, left-padded."""
    seq = synthetic.markov_sessions(num_items=ITEMS, num_sessions=BATCH,
                                    length=T, branching=4, noise=0.2,
                                    seed=seed)
    hist, pos = seq[:, :T].copy(), seq[:, 1:].copy()
    neg = np.random.default_rng(seed + 1).integers(
        1, ITEMS + 1, size=pos.shape).astype(np.int32)
    for row, keep in ((0, 5), (3, 16)):
        for a in (hist, pos, neg):
            a[row, : T - keep] = 0
    return {"item_history": hist, "positive_sequence": pos,
            "negative_sequence": neg}


def _pair(use_flash, seed=0):
    jmodel = jsasrec.SASRec(ITEMS, **WIDTHS, key=jax.random.key(seed))
    tmodel = sasrec.SASRec(ITEMS, **WIDTHS, device="cpu")
    for block in tmodel.blocks:
        block.attention.use_flash = use_flash
    convert.load_params(tmodel, torch_parity.jax_sasrec_params(jmodel))
    return jmodel, tmodel


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("use_flash", ["auto", True])
def test_forward_and_loss_match_jax(use_flash):
    jmodel, tmodel = _pair(use_flash)
    batch = _batch(1)
    hist = batch["item_history"]
    np.testing.assert_allclose(
        tmodel.encode(torch.from_numpy(hist)).detach().numpy(),
        np.asarray(jmodel.encode(jnp.asarray(hist))), **TOL)
    np.testing.assert_allclose(
        tmodel(torch.from_numpy(hist)).detach().numpy(),
        np.asarray(jmodel(jnp.asarray(hist))), **TOL)
    np.testing.assert_allclose(
        float(sasrec.sasrec_loss(tmodel, _torch(batch)).detach()),
        float(jsasrec.sasrec_loss(
            jmodel, {k: jnp.asarray(v) for k, v in batch.items()})),
        **TOL)


def test_score_items_and_retrieval_match_jax():
    jmodel, tmodel = _pair("auto", seed=1)
    hist = _batch(2)["item_history"]
    ids = np.random.default_rng(3).integers(0, ITEMS + 1, size=(BATCH, 7))
    juser = jmodel(jnp.asarray(hist))
    tuser = tmodel(torch.from_numpy(hist))
    np.testing.assert_allclose(
        tmodel.score_items(tuser, torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jmodel.score_items(juser, jnp.asarray(ids))), **TOL)
    j_scores, j_idx = jmodel.make_retrieval(k=10)(juser)
    t_scores, t_idx = tmodel.make_retrieval(k=10)(tuser)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_scores.detach().numpy(),
                               np.asarray(j_scores), **TOL)


@pytest.mark.parametrize("use_flash", ["auto", True])
def test_three_adam_steps_match_jax_trainer(use_flash):
    """Losses and parameters after 3 steps of the port's Trainer +
    DenseAdam and the JAX Trainer + optax.adam.

    eps is 1e-5 here, not optax's 1e-8: a parameter whose summed gradient
    cancels to ~1e-8 (one position-embedding entry in this batch) takes a
    step of about lr = 5e-3 whose size then hangs on the f32 summation
    order of its gradient (~5e-9 apart in the two packages), which would
    test that conditioning rather than the port.
    test_dense_adam_matches_optax holds the default eps.
    """
    jmodel, tmodel = _pair(use_flash, seed=2)
    batches = [_batch(10 + s) for s in range(3)]

    def data(to):
        counter = itertools.count()
        return lambda: iter([to(batches[next(counter)])])

    jtrainer = jtraining.Trainer(jmodel, optax.adam(0.005, eps=EPS),
                                 jsasrec.sasrec_loss)
    jhist = jtrainer.fit(
        data(lambda b: {k: jnp.asarray(v) for k, v in b.items()}),
        epochs=3, log_every=0)
    ttrainer = Trainer(tmodel, train_state.DenseAdam(tmodel.parameters(),
                                                     0.005, eps=EPS),
                       sasrec.sasrec_loss)
    thist = ttrainer.fit(data(lambda b: b), epochs=3, log_every=0)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], **TOL)
    want = torch_parity.jax_sasrec_params(jtrainer.model)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   err_msg=name, **TOL)


def test_markov_sessions_bit_exact():
    kw = dict(num_items=3706, num_sessions=64, length=200, branching=12,
              noise=0.2, seed=7)
    got = synthetic.markov_sessions(**kw)
    want = jsynthetic.markov_sessions(**kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_dense_adam_matches_optax():
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    opt = optax.adam(0.01)
    jparams = [jnp.asarray(p) for p in params]
    state = opt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
               for p in params]
    adam = train_state.DenseAdam(tparams, 0.01)
    for step_grads in grads:
        updates, state = opt.update([jnp.asarray(g) for g in step_grads],
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        adam.step()
        adam.zero_grad()
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-7)


def test_trainer_moves_numpy_batches_and_rejects_empty_data():
    _, tmodel = _pair("auto", seed=3)
    trainer = Trainer(tmodel, train_state.DenseAdam(tmodel.parameters(),
                                                    0.005),
                      sasrec.sasrec_loss)
    loss = trainer.step(_batch(4))
    assert loss.device == trainer.device and torch.isfinite(loss)
    with pytest.raises(ValueError, match="no batches"):
        trainer.fit([], epochs=1)
