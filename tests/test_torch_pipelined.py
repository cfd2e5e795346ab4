"""The port's pipelined (one-step-stale) embedding step
(keras_rs_tpu_torch/training/pipelined.py) against the JAX package's
(keras_rs_tpu/training/pipelined.py), on the CPU, on a one-device mesh,
from the same tables, dense parameters and batches.

The contract, as tests/test_pipelined.py states it for the JAX package:
step 0 equals the unpipelined step; the activations consumed at step
t+1 were gathered before update t; the prefetch does not depend on the
dense parameters. The port adds: the table update comes from the
cotangent, with no second stacked gather.

Tolerances:
  * step 0 against the unpipelined step, the prefetch against a gather
    of the same tables: equal (the same formulas on the same numbers);
  * 6 pipelined steps against the JAX run, f32 dense stack: losses and
    tables within 1e-5 (summation order of matmuls and segment sums, a
    few f32 ulp per step), as tests/test_torch_dlrm.py holds 3 steps;
    the last dense kernel within 1e-4 relative plus the losses' bound;
  * bf16 tables with row-wise Adagrad: losses within 1e-4 and tables
    within one bf16 ulp per step plus 1e-4 (each package rounds its
    updates stochastically with its own random bits), as
    tests/test_torch_dlrm.py's capacity case.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch_parity
from torch_parity import B, LR, MULTI_HOT, VOCAB, bf16_ulp, build_pair

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.embedding import lookup
from keras_rs_tpu_torch.models import dlrm as torch_dlrm
from keras_rs_tpu_torch.training import checkpoint, pipelined, train_state

F32 = dict(compute_dtype=None, dense_output_dtype="float32")
LAYOUTS = {
    "packed": dict(F32),
    "split": dict(F32, embedding_optimizer="rowwise_adagrad"),
    "split_bf16": dict(F32, table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad",
                       embedding_dim=32, bottom_mlp=(64, 32)),
}
STEPS = 6


def _raws(n=STEPS, base=10):
    return [synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                        multi_hot_sizes=MULTI_HOT,
                                        seed=base + i % 3)
            for i in range(n)]


def _pair(layout, seed=2):
    return build_pair(seed=seed, carry_states=layout == "split_bf16",
                      **LAYOUTS[layout])


def _torch_pipelined(tmodel, raws, loss_fn=torch_dlrm.bce_loss,
                     has_aux=False):
    """(outputs, state) of one pipelined step per batch, each feeding
    the next batch's embedding input (the last its own)."""
    opt = train_state.DenseAdagrad(tmodel.parameters(), LR)
    embed_fn, get_pre, inject = pipelined.dlrm_pipeline_fns()
    batches = [tmodel.preprocess(r) for r in raws]
    state = pipelined.create_pipelined_train_state(
        tmodel, opt, get_pre(batches[0]), embed_fn)
    step = pipelined.make_pipelined_train_step(
        loss_fn, opt, embed_fn, get_pre, inject, has_aux=has_aux)
    outs = []
    for t, batch in enumerate(batches):
        nxt = batches[min(t + 1, len(batches) - 1)]
        state, out = step(state, batch, get_pre(nxt))
        outs.append(out)
    return outs, state


def _jax_pipelined(jmodel, raws, loss_fn=jax_dlrm.bce_loss, has_aux=False):
    opt = optax.adagrad(LR)
    embed_fn, get_pre, inject = jax_training.dlrm_pipeline_fns()
    batches = [jmodel.preprocess(r) for r in raws]
    state = jax_training.create_pipelined_train_state(
        jmodel, opt, get_pre(batches[0]), embed_fn)
    step = jax_training.make_pipelined_train_step(
        loss_fn, opt, embed_fn, get_pre, inject, has_aux=has_aux,
        donate=False)
    outs = []
    for t, batch in enumerate(batches):
        nxt = batches[min(t + 1, len(batches) - 1)]
        state, out = step(state, batch, get_pre(nxt))
        outs.append(out)
    return outs, state


def _first_step(tmodel, raws):
    """The state after step 0 on raws[0], its prefetch batch 1's."""
    opt = train_state.DenseAdagrad(tmodel.parameters(), LR)
    embed_fn, get_pre, inject = pipelined.dlrm_pipeline_fns()
    b0, b1 = (tmodel.preprocess(r) for r in raws[:2])
    state = pipelined.create_pipelined_train_state(tmodel, opt, get_pre(b0),
                                                   embed_fn)
    step = pipelined.make_pipelined_train_step(
        torch_dlrm.bce_loss, opt, embed_fn, get_pre, inject)
    return step(state, b0, get_pre(b1))[0]


def _embed(model, raw):
    """A gather of the model's current tables for a raw batch."""
    with torch.no_grad():
        return model.embedding_layer(model.preprocess(raw)["large_pre"])


def _assert_acts_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step0_matches_unpipelined(layout):
    raws = _raws(2)
    _, plain = _pair(layout)
    _, piped = _pair(layout)
    opt = train_state.DenseAdagrad(plain.parameters(), LR)
    loss = train_state.make_train_step(plain, torch_dlrm.bce_loss, opt)(
        plain.preprocess(raws[0]))
    (ploss, _), _ = _torch_pipelined(piped, raws)
    assert float(loss) == float(ploss)
    # Only staleness would tell the two apart, and it starts at step 1:
    # after one step every parameter and buffer is equal.
    _, piped = _pair(layout)
    _torch_pipelined(piped, raws[:1])
    for (name, a), (_, b) in zip(plain.state_dict().items(),
                                 piped.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefetched_acts_are_one_update_old(layout):
    raws = _raws(2)
    _, start = _pair(layout)
    _, tmodel = _pair(layout)
    state = _first_step(tmodel, raws)
    # Batch 1's activations read the tables before step 0's update: the
    # initial tables.
    _assert_acts_equal(state.prefetched.acts, _embed(start, raws[1]))
    # A fresh gather of the updated tables differs (touched rows moved).
    fresh = _embed(tmodel, raws[1])
    assert max(float((state.prefetched.acts[k] - fresh[k]).abs().max())
               for k in fresh) > 0.0


def test_prefetch_is_dense_independent_and_gathers_once(monkeypatch):
    """Two models with the same tables and different dense parameters
    prefetch the same activations; each step runs one stacked gather
    per stack (the prefetch): the update comes from the cotangent."""
    raws = _raws(3)
    _, a = _pair("packed")
    _, b = _pair("packed")
    with torch.no_grad():
        for p in b.top_mlp.parameters():
            p.mul_(3.0)
    gathers = []
    real = lookup.stack_gather
    monkeypatch.setattr(lookup, "stack_gather",
                        lambda *args: gathers.append(1) or real(*args))
    _, sa = _torch_pipelined(a, raws)
    n_stacks = len(a.embedding_layer.stacks)
    # prime + one prefetch per step.
    assert len(gathers) == n_stacks * (1 + len(raws))
    # Step 0's prefetch (batch 1) with either dense stack: the same.
    _assert_acts_equal(_first_step(b, raws).prefetched.acts,
                       _first_step(_pair("packed")[1], raws).prefetched.acts)
    assert sa.step == len(raws)
    for i in range(n_stacks):
        assert float(a.embedding_layer.stack_state(i)["step"]) == len(raws)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_run_tracks_jax(layout):
    raws = _raws()
    jmodel, tmodel = _pair(layout)
    j_losses, jstate = _jax_pipelined(jmodel, raws)
    t_losses, tstate = _torch_pipelined(tmodel, raws)
    j_losses = [float(x) for x in j_losses]
    t_losses = [float(x) for x in t_losses]
    bf16 = layout == "split_bf16"
    tol = 1e-4 if bf16 else 1e-5
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol, atol=tol)
    assert np.isfinite(t_losses).all()
    j_tables = jstate.model.embedding_layer.get_embedding_tables()
    for name, t in tmodel.embedding_layer.get_embedding_tables().items():
        got = t.float().numpy()
        want = np.asarray(j_tables[name]).astype(np.float32)
        if bf16:
            bound = (STEPS * bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
                     + 1e-4)
            assert (np.abs(got - want) <= bound).all(), name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    j_kernel = np.asarray(jstate.model.top_mlp.layers[-1].kernel)
    np.testing.assert_allclose(
        tmodel.top_mlp.layers[-1].kernel.detach().numpy(), j_kernel,
        rtol=1e-4, atol=tol)
    for i in range(len(tmodel.embedding_layer.stacks)):
        assert float(tmodel.embedding_layer.stack_state(i)["step"]) == STEPS
    assert tstate.step == STEPS


def test_dense_placement_tables_get_gradients():
    """table_placement="auto" keeps the large tables as dense EmbedReduce
    tables on one device in both packages: the pipelined update routes
    their cotangents through autograd into `.grad`, and the dense
    optimizer trains them as the JAX step's extra_dense_grads do."""
    raws = _raws(4)
    kw = torch_parity.dlrm_config_kwargs(table_placement="auto", **F32)
    jmodel = jax_dlrm.DLRMDCNv2(jax_dlrm.DLRMConfig(**kw),
                                key=jax.random.key(3),
                                mesh=torch_parity.one_device_mesh())
    tmodel = torch_dlrm.DLRMDCNv2(torch_dlrm.DLRMConfig(**kw), device="cpu")
    params, tables = torch_parity.jax_dlrm_params(jmodel)
    params.update({f"embedding_layer.dense_tables.{k}.embeddings": v
                   for k, v in tables.items()})
    convert.load_params(tmodel, params)
    emb = tmodel.embedding_layer
    assert not emb.stacks and len(emb.dense_tables) == 2
    before = {k: v.detach().clone()
              for k, v in emb.get_embedding_tables().items()}
    j_losses, jstate = _jax_pipelined(jmodel, raws)
    t_losses, _ = _torch_pipelined(tmodel, raws)
    np.testing.assert_allclose([float(x) for x in t_losses],
                               [float(x) for x in j_losses],
                               rtol=1e-5, atol=1e-5)
    for name, er in emb.dense_tables.items():
        assert er.embeddings.grad is not None
        assert float(er.embeddings.grad.abs().sum()) > 0.0, name
    j_tables = jstate.model.embedding_layer.get_embedding_tables()
    for name, t in emb.get_embedding_tables().items():
        assert not torch.equal(t, before[name]), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j_tables[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _aux_loss(lib):
    def loss_fn(model, batch):
        loss = (jax_dlrm if lib == "jax" else torch_dlrm).bce_loss(
            model, batch)
        return loss, {"twice": 2 * loss, "pair": (loss + 1, loss * loss)}
    return loss_fn


def test_has_aux_through_the_pipelined_step():
    raws = _raws(4)
    jmodel, tmodel = _pair("packed")
    _, plain = _pair("packed")
    j_outs, _ = _jax_pipelined(jmodel, raws, _aux_loss("jax"), has_aux=True)
    t_outs, _ = _torch_pipelined(tmodel, raws, _aux_loss("torch"),
                                 has_aux=True)
    plain_losses, _ = _torch_pipelined(plain, raws)
    for (tl, taux), (jl, jaux), pl in zip(t_outs, j_outs, plain_losses):
        assert float(tl) == float(pl)  # the aux changes nothing
        assert not tl.requires_grad and not taux["twice"].requires_grad
        assert isinstance(taux["pair"], tuple)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for got, want in ((taux["twice"], jaux["twice"]),
                          (taux["pair"][0], jaux["pair"][0]),
                          (taux["pair"][1], jaux["pair"][1])):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_pipelined_state_checkpoint_round_trip(tmp_path):
    """save_checkpoint / restore_checkpoint of a PipelinedTrainState: the
    restored state (model, dense optimizer, step), re-primed from the
    next batch as a resumed loop does, continues exactly as the one that
    stayed in memory and re-primed from the same batch. The prefetch is
    not saved: the restore keeps the live one."""
    raws = _raws(5)
    _, a = _pair("packed")
    _, b = _pair("packed", seed=7)
    opt_a = train_state.DenseAdagrad(a.parameters(), LR)
    opt_b = train_state.DenseAdagrad(b.parameters(), LR)
    embed_fn, get_pre, inject = pipelined.dlrm_pipeline_fns()
    ba = [a.preprocess(r) for r in raws]
    sa = pipelined.create_pipelined_train_state(a, opt_a, get_pre(ba[0]),
                                                embed_fn)
    sb = pipelined.create_pipelined_train_state(b, opt_b, get_pre(ba[3]),
                                                embed_fn)
    step_a = pipelined.make_pipelined_train_step(
        torch_dlrm.bce_loss, opt_a, embed_fn, get_pre, inject)
    step_b = pipelined.make_pipelined_train_step(
        torch_dlrm.bce_loss, opt_b, embed_fn, get_pre, inject)
    for t in range(2):
        step_a(sa, ba[t], get_pre(ba[t + 1]))
    checkpoint.save_checkpoint(str(tmp_path / "ck"), sa)
    live = sb.prefetched
    checkpoint.restore_checkpoint(str(tmp_path / "ck"), sb)
    assert sb.step == 2
    assert sb.prefetched is live
    sa.prefetched = pipelined.prime(a, get_pre(ba[2]), embed_fn)
    sb.prefetched = pipelined.prime(b, get_pre(ba[2]), embed_fn)
    la = [float(step_a(sa, ba[t], get_pre(ba[t + 1]))[1]) for t in (2, 3)]
    lb = [float(step_b(sb, ba[t], get_pre(ba[t + 1]))[1]) for t in (2, 3)]
    assert la == lb
