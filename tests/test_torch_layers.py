"""The port's dense building blocks and dense optimizer against the JAX
package's, from identical parameters and numpy inputs. f32 throughout:
tolerance 1e-5 (same formulas; matmul summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers import dense as jax_dense
from keras_rs_tpu.layers.embedding import embed_reduce as jax_er
from keras_rs_tpu.layers.feature_interaction import (
    feature_cross as jax_fc,
)
from keras_rs_tpu_torch.layers import dense
from keras_rs_tpu_torch.layers.embedding import embed_reduce
from keras_rs_tpu_torch.layers.feature_interaction import feature_cross
from keras_rs_tpu_torch.training import train_state

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(8, 4), (8,)], ids=["2d", "1d"])
def test_embed_reduce_matches_jax(combiner, weighted, shape):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=shape)
    w = None
    if weighted:
        w = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
        w[0] = 0.0  # an all-padding row: divide_no_nan gives 0
    ref = jax_er.EmbedReduce(50, 16, table=jnp.asarray(table),
                             combiner=combiner)
    ours = embed_reduce.EmbedReduce(50, 16, combiner=combiner,
                                   device="cpu")
    with torch.no_grad():
        ours.embeddings.copy_(torch.from_numpy(table))
    want = np.asarray(ref(ids, None if w is None else jnp.asarray(w)))
    got = ours(torch.from_numpy(ids),
               None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("shape", [(6, 3), (6,)], ids=["2d", "1d"])
def test_embed_reduce_out_of_range_ids_match_jax(combiner, shape):
    """jnp.take's rows: an id >= vocab (or < -vocab) gives a NaN row, a
    negative id counts from the end (-1 is the last row)."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((20, 8)).astype(np.float32)
    ids = rng.integers(0, 20, size=shape)
    ids.flat[0] = 20
    ids.flat[1] = -1
    ids.flat[2] = 10**6
    ids.flat[3] = -21
    ids.flat[4] = -20
    ref = jax_er.EmbedReduce(20, 8, table=jnp.asarray(table),
                             combiner=combiner)
    ours = embed_reduce.EmbedReduce(20, 8, combiner=combiner, device="cpu")
    with torch.no_grad():
        ours.embeddings.copy_(torch.from_numpy(table))
    want = np.asarray(ref(ids))
    got = ours(torch.from_numpy(ids)).detach().numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    # The rows of valid ids still get their gradient; the NaN rows none.
    loss = ours(torch.from_numpy(ids[1:])).nansum()
    loss.backward()
    assert bool(torch.isfinite(ours.embeddings.grad).all())
    assert float(ours.embeddings.grad[19].abs().sum()) > 0  # id -1


def test_mlp_and_feature_cross_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 24)).astype(np.float32)
    jmlp = jax_dense.MLP(24, (16, 24), key=jax.random.key(0))
    tmlp = dense.MLP(24, (16, 24), device="cpu")
    jcross = jax_fc.FeatureCross(24, key=jax.random.key(1),
                                 projection_dim=8)
    tcross = feature_cross.FeatureCross(24, projection_dim=8,
                                        device="cpu")
    with torch.no_grad():
        for jl, tl in zip(jmlp.layers, tmlp.layers):
            tl.kernel.copy_(torch.from_numpy(np.array(jl.kernel)))
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias)))
        for name in ("down_proj_kernel", "kernel", "bias"):
            getattr(tcross, name).copy_(
                torch.from_numpy(np.array(getattr(jcross, name))))
    jy = jmlp(jnp.asarray(x))
    want = np.asarray(jcross(jnp.asarray(x), jy))
    ty = tmlp(torch.from_numpy(x))
    got = tcross(torch.from_numpy(x), ty)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_dense_adagrad_matches_optax():
    """optax's formula (eps inside the root, accumulator from 0.1), which
    torch.optim.Adagrad does not compute."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32)
             for _ in range(3)]
    opt = optax.adagrad(0.1)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ours = train_state.DenseAdagrad([p], 0.1)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        p.grad = torch.from_numpy(g)
        ours.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)
    ours.zero_grad()
    assert p.grad is None
