"""The port's GRU (layers/recurrent.py) and GRU4Rec (models/gru4rec.py)
against the JAX package's, from identical parameters (moved with
keras_rs_tpu_torch.convert) and numpy inputs, on the CPU.

Tolerances (f32): the GRU's final state within 1e-6 absolute (states
are bounded by 1: each step is a convex mix of the previous state and a
tanh), its gradients within 1e-5 of each array's largest magnitude
(sums over the batch and the steps in another order); GRU4Rec's query
vectors and loss within 1e-6 relative, its top-10 ids equal (tie-free
scores); 3 Adam steps
through Trainer against the JAX Trainer with optax.adam: losses and
parameters within 1e-5; a run resumed from Trainer.fit's `last`
checkpoint against the run that went on in memory: equal losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import jax_attr, load_from_jax

from keras_rs_tpu import training as jtraining
from keras_rs_tpu.layers import recurrent as jrecurrent
from keras_rs_tpu.models import gru4rec as jgru4rec
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.recurrent import GRU
from keras_rs_tpu_torch.models.gru4rec import GRU4Rec, gru4rec_loss
from keras_rs_tpu_torch.training import checkpoint, train_state
from keras_rs_tpu_torch.training.trainer import Trainer

B, T, IN, H = 6, 7, 5, 8
ITEMS, DIM, HIST = 40, 16, 6

MASKS = {
    "none": None,
    "full": np.ones((B, T), np.float32),
    "left_padded": (np.arange(T)[None, :]
                    >= np.array([0, 2, 5, 6, 1, 3])[:, None]).astype(
                        np.float32),
    "holes": (np.random.default_rng(3).random((B, T)) > 0.4).astype(
        np.float32),
    "all_padded_row": np.concatenate(
        [np.zeros((1, T)), np.ones((B - 1, T))]).astype(np.float32),
}


def _gru_pair(seed=0):
    jgru = jrecurrent.GRU(IN, H, key=jax.random.key(seed))
    return jgru, load_from_jax(GRU(IN, H, device="cpu"), jgru)


@pytest.mark.parametrize("mask_name", list(MASKS))
def test_gru_forward_and_gradients_match_jax(mask_name):
    jgru, tgru = _gru_pair()
    x = np.random.default_rng(1).standard_normal((B, T, IN)).astype(
        np.float32)
    mask = MASKS[mask_name]
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jloss(g, xx):
        h = g(xx, mask=jm)
        return jnp.sum(h * jnp.arange(1, H + 1)), h

    (_, jh), (jg, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jgru, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    h = tgru(tx, mask=tm)
    (h * torch.arange(1, H + 1)).sum().backward()
    assert h.shape == (B, H)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    for name, got, want in [("x", tx.grad, jgx)] + [
            (n, p.grad, getattr(jg, n)) for n, p in tgru.named_parameters()]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)
    if mask_name == "all_padded_row":  # no real step: the state stays 0
        assert not h[0].detach().any()


def test_gru_masking_carries_state():
    """A mask that cuts the last steps gives the state after the prefix
    (JAX tests/test_sequential_models.py), and a padded step leaves the
    state bit for bit as it was."""
    _, tgru = _gru_pair()
    x = torch.randn(2, 5, IN, generator=torch.Generator().manual_seed(1))
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 0, 0]],
                        dtype=torch.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tgru(x, mask=mask).numpy(),
                                   tgru(x[:, :3], mask=mask[:, :3]).numpy(),
                                   rtol=1e-5)
        holes = torch.tensor([[1, 0, 1, 0, 0]], dtype=torch.float32)
        dense = torch.stack([x[0, 0], x[0, 2]])[None]
        assert torch.equal(tgru(x[:1], mask=holes), tgru(dense))


def test_gru_layout_and_init():
    g = GRU(IN, H, generator=torch.Generator().manual_seed(0), device="cpu")
    assert g.kernel.shape == (IN, 3 * H)
    assert g.recurrent_kernel.shape == (H, 3 * H)
    assert not g.bias.any() and not g.recurrent_bias.any()
    assert float(g.kernel.detach().abs().max()) <= (6 / (IN + 3 * H)) ** 0.5
    big = GRU(4, 256, generator=torch.Generator().manual_seed(0),
              device="cpu")
    np.testing.assert_allclose(float(big.recurrent_kernel.detach().std()),
                               (1 / 256) ** 0.5, rtol=0.02)


def _sessions(seed, n=24, left_pad=True):
    seq = synthetic.markov_sessions(num_items=ITEMS, num_sessions=n,
                                    length=HIST + 1, branching=4, noise=0.2,
                                    seed=seed)
    hist = seq[:, :-1].copy()
    if left_pad:
        for row, keep in ((0, 2), (5, 4), (9, 1)):
            hist[row, : HIST - keep] = 0
    return {"item_history": hist, "target_item": seq[:, -1].copy()}


def _model_pair(seed=0):
    jmodel = jgru4rec.GRU4Rec(ITEMS, embedding_dim=DIM,
                              key=jax.random.key(seed))
    tmodel = load_from_jax(GRU4Rec(ITEMS, embedding_dim=DIM, device="cpu"),
                           jmodel)
    return jmodel, tmodel


def test_gru4rec_forward_loss_and_top10_match_jax():
    jmodel, tmodel = _model_pair()
    batch = _sessions(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        q = tmodel.query_tower(tbatch["item_history"])
        loss = gru4rec_loss(tmodel, tbatch)
        top = tmodel.make_retrieval(k=10)(q)
    jq = jmodel.query_tower(jbatch["item_history"])
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(loss),
                               float(jgru4rec.gru4rec_loss(jmodel, jbatch)),
                               rtol=1e-6)
    jtop = np.asarray(jmodel.make_retrieval(k=10)(jq))
    assert top.shape == (24, 10)
    np.testing.assert_array_equal(top.numpy(), jtop)
    # forward is the query tower; the mask defaults to ids != 0.
    with torch.no_grad():
        assert torch.equal(tmodel(tbatch["item_history"]), q)
        mask = (tbatch["item_history"] != 0).float()
        assert torch.equal(tmodel.query_tower(tbatch["item_history"], mask),
                           q)


def _one_batch_per_epoch(batches):
    it = iter(batches)
    return lambda: [next(it)]


def test_three_adam_steps_through_trainer_match_jax():
    jmodel, tmodel = _model_pair(seed=1)
    batches = [_sessions(s) for s in (10, 11, 12)]
    jtrainer = jtraining.Trainer(jmodel, optax.adam(0.01),
                                 jgru4rec.gru4rec_loss)
    jhist = jtrainer.fit(_one_batch_per_epoch(
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
        epochs=3, log_every=0)
    trainer = Trainer(tmodel, train_state.DenseAdam(tmodel.parameters(),
                                                    0.01), gru4rec_loss)
    hist = trainer.fit(_one_batch_per_epoch(batches), epochs=3, log_every=0)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jax_attr(jtrainer.model, name)),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_resume_from_fit_checkpoint_continues_exactly(tmp_path):
    """fit(checkpoint_dir) writes `last`; a fresh model restored from it
    trains on with the losses of the run that went on in memory."""
    batches = [_sessions(s) for s in range(20, 26)]
    _, model = _model_pair(seed=2)
    trainer = Trainer(model, train_state.DenseAdam(model.parameters(), 0.01),
                      gru4rec_loss)
    trainer.fit(_one_batch_per_epoch(batches[:3]), epochs=3, log_every=0,
                checkpoint_dir=str(tmp_path))
    in_memory = [float(trainer.step(b)) for b in batches[3:]]
    fresh = GRU4Rec(ITEMS, embedding_dim=DIM, device="cpu",
                    generator=torch.Generator().manual_seed(9))
    resumed = Trainer(fresh, train_state.DenseAdam(fresh.parameters(), 0.01),
                      gru4rec_loss)
    checkpoint.restore_checkpoint(str(tmp_path / "last"), resumed.state)
    assert resumed.optimizer.count == 3
    assert [float(resumed.step(b)) for b in batches[3:]] == in_memory
