"""The port's weight regularizers (core/regularizers.py) and their layers
(Dense, MLP, FeatureCross, EmbedReduce) against the JAX package's
(`tests/test_api_parity_r2.py::TestRegularizers` and
`test_regularization_in_train_step`), from identical weights moved with
keras_rs_tpu_torch.convert, on the CPU.

Tolerances: penalties and gradients f32, 1e-6 relative (sums of a few
hundred squares in another order); one Adagrad step of a regularized
Dense 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_parity import load_from_jax

from keras_rs_tpu import training as jtraining
from keras_rs_tpu.core import regularizers as jreg
from keras_rs_tpu.layers import dense as jdense
from keras_rs_tpu.layers.embedding import embed_reduce as jembed
from keras_rs_tpu.layers.feature_interaction import feature_cross as jcross
from keras_rs_tpu_torch.core import regularizers as reg_lib
from keras_rs_tpu_torch.layers import dense
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
    FeatureCross,
)
from keras_rs_tpu_torch.training import train_state

TOL = dict(rtol=1e-6, atol=0)


@pytest.mark.parametrize("reg, want", [
    (lambda lib: lib.L1(0.5), 0.5 * 10.0),
    (lambda lib: lib.L2(0.5), 0.5 * 30.0),
    (lambda lib: lib.L1L2(0.1, 0.2), 0.1 * 10 + 0.2 * 30),
], ids=["l1", "l2", "l1l2"])
def test_penalty_math_matches_keras(reg, want):
    x = np.asarray([[1.0, -2.0], [3.0, -4.0]], np.float32)
    got = float(reg(reg_lib)(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, float(reg(jreg)(jnp.asarray(x))),
                               rtol=1e-6)


def test_get_by_name_and_serialization():
    assert isinstance(reg_lib.get("l2"), reg_lib.L2)
    assert reg_lib.get(None) is None
    spec = reg_lib.serialize(reg_lib.L1L2(0.3, 0.7))
    assert spec == jreg.serialize(jreg.L1L2(0.3, 0.7))
    assert reg_lib.deserialize(spec) == reg_lib.L1L2(0.3, 0.7)
    assert reg_lib.deserialize("l1") == reg_lib.L1()
    wrapped = reg_lib.get(lambda x: x.sum())
    assert float(wrapped(torch.ones(3))) == 3.0
    with pytest.raises(ValueError, match="cannot be serialized"):
        wrapped.get_config()
    with pytest.raises(ValueError, match="Unknown regularizer"):
        reg_lib.get("l3")


@pytest.mark.parametrize("projection_dim, use_bias", [
    (None, True), (4, False), (4, True)], ids=["full", "low_rank_no_bias",
                                              "low_rank"])
def test_feature_cross_regularization_loss(projection_dim, use_bias):
    """Full rank: L2 on the kernel, L1 on the bias; low rank: both
    kernels take the kernel regularizer (the JAX cases)."""
    kw = dict(projection_dim=projection_dim, use_bias=use_bias,
              kernel_regularizer="l2", bias_regularizer="l1")
    jlayer = jcross.FeatureCross(8, key=jax.random.key(0),
                                 kernel_regularizer=jreg.L2(0.01),
                                 bias_regularizer="l1",
                                 projection_dim=projection_dim,
                                 use_bias=use_bias)
    tlayer = load_from_jax(FeatureCross(8, device="cpu", **kw), jlayer)
    got = reg_lib.regularization_loss(tlayer).detach()
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               float(jreg.regularization_loss(jlayer)),
                               **TOL)
    expected = 0.01 * float((tlayer.kernel ** 2).sum())
    if projection_dim is not None:
        expected += 0.01 * float((tlayer.down_proj_kernel ** 2).sum())
    if use_bias:
        expected += 0.01 * float(tlayer.bias.abs().sum())
    np.testing.assert_allclose(float(got), expected, **TOL)


def test_walks_nested_modules_and_is_differentiable():
    jmlp = jdense.MLP(4, [8, 2], key=jax.random.key(0),
                      kernel_regularizer=jreg.L2(0.1))
    tmlp = load_from_jax(dense.MLP(4, [8, 2], device="cpu",
                                   kernel_regularizer=reg_lib.L2(0.1)),
                         jmlp)
    loss = reg_lib.regularization_loss(tmlp)
    np.testing.assert_allclose(float(loss),
                               float(jreg.regularization_loss(jmlp)), **TOL)
    loss.backward()
    jgrads = jax.grad(jreg.regularization_loss)(jmlp)
    for i, layer in enumerate(tmlp.layers):
        np.testing.assert_allclose(layer.kernel.grad.numpy(),
                                   np.asarray(jgrads.layers[i].kernel),
                                   rtol=1e-5)
        np.testing.assert_allclose(layer.kernel.grad.numpy(),
                                   0.2 * layer.kernel.detach().numpy(),
                                   rtol=1e-5)
        assert layer.bias.grad is None  # no bias regularizer


def test_embed_reduce_embeddings_regularizer():
    jlayer = jembed.EmbedReduce(10, 4, key=jax.random.key(0),
                                embeddings_regularizer=jreg.L2(0.5))
    tlayer = load_from_jax(
        EmbedReduce(10, 4, embeddings_regularizer=reg_lib.L2(0.5),
                    device="cpu"), jlayer)
    np.testing.assert_allclose(float(reg_lib.regularization_loss(tlayer)),
                               float(jreg.regularization_loss(jlayer)),
                               **TOL)
    # The int8 copy keeps no regularizer, as in the JAX package.
    q = tlayer.quantize_int8()
    assert q.embeddings_regularizer is None
    assert float(reg_lib.regularization_loss(q)) == 0.0


def test_no_registration_is_zero():
    layer = FeatureCross(8, device="cpu")
    got = reg_lib.regularization_loss(layer)
    assert float(got) == 0.0 and got.device == layer.kernel.device
    assert float(jreg.regularization_loss(
        jcross.FeatureCross(8, key=jax.random.key(0)))) == 0.0


def test_cross_serialization_round_trip():
    layer = FeatureCross(8, kernel_regularizer=reg_lib.L2(0.3), device="cpu")
    cfg = layer.get_config()
    jcfg = jcross.FeatureCross(8, key=jax.random.key(0),
                               kernel_regularizer=jreg.L2(0.3)).get_config()
    assert cfg == jcfg
    restored = FeatureCross.from_config({**cfg, "device": "cpu"})
    assert restored.kernel_regularizer == reg_lib.L2(0.3)
    assert restored.bias_regularizer is None


def test_regularization_in_train_step():
    """A loss that is the penalty alone: one Adagrad step shrinks |W|,
    and the kernel equals optax's after the same step; the unregularized
    bias takes a zero gradient and stays."""
    jmodel = jdense.Dense(4, 2, key=jax.random.key(0),
                          kernel_regularizer=jreg.L2(0.5))
    tmodel = load_from_jax(
        dense.Dense(4, 2, kernel_regularizer=reg_lib.L2(0.5), device="cpu"),
        jmodel)

    def jloss(model, batch):
        return jreg.regularization_loss(model)

    def tloss(model, batch):
        return reg_lib.regularization_loss(model)

    opt = optax.adagrad(0.1)
    jstate = jtraining.create_train_state(jmodel, opt)
    jstate, _ = jtraining.make_train_step(jloss, opt, donate=False)(
        jstate, None)
    before = tmodel.kernel.detach().abs().sum().item()
    step = train_state.make_train_step(
        tmodel, tloss, train_state.DenseAdagrad(tmodel.parameters(), 0.1))
    step(None)
    assert tmodel.kernel.detach().abs().sum().item() < before
    np.testing.assert_allclose(tmodel.kernel.detach().numpy(),
                               np.asarray(jstate.model.kernel), **TOL)
    assert not tmodel.bias.detach().any()
