"""The port's pipelined (one-step-stale) DLRM step sharded over D = 2
and D = 8 gloo CPU ranks (tests/torch_dist_workers.py), in device
preprocessing mode as the ml_perf entry point runs it, against the JAX
package's pipelined step on its 8-device virtual CPU mesh
(tests/test_pipelined.py:202's cross-mesh protocol), from the same
parameters and batches.

Bounds, as tests/test_torch_pipelined.py holds one device:
  * step 0 against the unpipelined data-parallel step at the same D:
    equal (the same collectives on the same numbers), the loss and every
    parameter and table after it;
  * 6 steps against the JAX run: the packed layout (f32 tables,
    Adagrad) losses and tables within 1e-5; the split layout (bf16
    tables, row-wise Adagrad) losses within 1e-4 and tables within one
    bf16 ulp per step plus 1e-4 (each package rounds stochastically with
    its own bits);
  * the last dense kernel within 1e-4 relative plus the losses' bound.
"""

import jax
import numpy as np
import optax
import pytest
import torch_dist_workers as workers
from torch_parity import (
    B,
    LR,
    MULTI_HOT,
    VOCAB,
    bf16_ulp,
    dlrm_config_kwargs,
    jax_dlrm_params,
    jax_stack_states,
)

from keras_rs_tpu import training as jax_training
from keras_rs_tpu.models import dlrm as jax_dlrm
from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu_torch.data import synthetic

F32 = dict(compute_dtype=None, dense_output_dtype="float32")
LAYOUTS = {
    "packed": dict(F32),
    "split_bf16": dict(F32, table_dtype="bfloat16",
                       embedding_optimizer="rowwise_adagrad",
                       embedding_dim=32, bottom_mlp=(64, 32)),
}
STEPS = 6


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def _raws(n=STEPS, base=10):
    return [synthetic.criteo_like_batch(B, vocab_sizes=VOCAB,
                                        multi_hot_sizes=MULTI_HOT,
                                        seed=base + i % 3)
            for i in range(n)]


def _jax_model(layout, D=8, seed=2):
    kw = dlrm_config_kwargs(**LAYOUTS[layout])
    jmodel = jax_dlrm.DLRMDCNv2(jax_dlrm.DLRMConfig(**kw),
                                key=jax.random.key(seed),
                                mesh=jmesh.create_mesh(jax.devices()[:D]))
    params, tables = jax_dlrm_params(jmodel)
    # bf16 tables travel as whole stack states, global arrays that each
    # rank cuts to its block (convert.load_params), with their layout.
    states = None
    if layout == "split_bf16":
        states = jax_stack_states(jmodel.embedding_layer)
        for s in jmodel.embedding_layer.stacks:
            states[s.name]["layout"] = [(t.name, t.local_offset, t.rotation)
                                        for t in s.tables]
    return jmodel, kw, params, tables, states


def _jax_pipelined(jmodel, raws):
    opt = optax.adagrad(LR)
    embed_fn, get_pre, inject = jax_training.dlrm_pipeline_fns()
    batches = [jmodel.preprocess(r) for r in raws]
    state = jax_training.create_pipelined_train_state(
        jmodel, opt, get_pre(batches[0]), embed_fn)
    step = jax_training.make_pipelined_train_step(
        jax_dlrm.bce_loss, opt, embed_fn, get_pre, inject, donate=False)
    losses = []
    for t, batch in enumerate(batches):
        nxt = batches[min(t + 1, len(batches) - 1)]
        state, loss = step(state, batch, get_pre(nxt))
        losses.append(float(loss))
    return losses, state.model


def _run(ranks, D, layout, raws, pipelined=True):
    _, kw, params, tables, states = _jax_model(layout, D=D)
    return ranks(D).run(
        "pipelined_case", config=kw, params=params, batches=raws,
        tables=None if states else tables, states=states,
        pipelined=pipelined)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_step0_matches_the_unpipelined_step_at_two_ranks(ranks, layout):
    raws = _raws(2)
    plain = _run(ranks, 2, layout, raws[:1], pipelined=False)
    piped = _run(ranks, 2, layout, raws[:1])
    for p, q in zip(plain, piped):
        assert p["losses"] == q["losses"]
        for k in p["params"]:
            np.testing.assert_array_equal(q["params"][k], p["params"][k],
                                          err_msg=k)
        for k in p["tables"]:
            np.testing.assert_array_equal(q["tables"][k], p["tables"][k],
                                          err_msg=k)
    assert piped[0]["losses"] == piped[1]["losses"]


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_run_tracks_jax_on_eight_devices(ranks, layout, D):
    raws = _raws()
    jmodel, *_ = _jax_model(layout)
    j_losses, j_after = _jax_pipelined(jmodel, raws)
    j_params, j_tables = jax_dlrm_params(j_after)
    bf16 = layout == "split_bf16"
    tol = 1e-4 if bf16 else 1e-5
    got = _run(ranks, D, layout, raws)
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["losses"], j_losses, rtol=tol,
                                   atol=tol, err_msg=f"rank {r}")
        assert out["state_step"] == STEPS and set(out["steps"]) == {STEPS}
        for name, t in out["tables"].items():
            want = np.asarray(j_tables[name]).astype(np.float32)
            if bf16:
                bound = (STEPS * bf16_ulp(np.maximum(np.abs(t),
                                                     np.abs(want))) + 1e-4)
                assert (np.abs(t - want) <= bound).all(), name
            else:
                np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-5,
                                           err_msg=name)
        k = "top_mlp.layers.2.kernel"
        np.testing.assert_allclose(out["params"][k], j_params[k], rtol=1e-4,
                                   atol=tol)
    # Data parallel: every rank holds the same global loss and replicas.
    assert len({tuple(o["losses"]) for o in got}) == 1
    for k in got[0]["params"]:
        for o in got[1:]:
            np.testing.assert_array_equal(o["params"][k],
                                          got[0]["params"][k])
