"""The port's FeatureCross (full rank and low rank, every option) and
DotInteraction against the JAX package's, from identical weights (moved
with keras_rs_tpu_torch.convert) and numpy inputs, on the CPU; their
configs against the JAX configs.

Tolerance: f32, 1e-5 of each array's largest magnitude on outputs and
gradients (sums of a few dozen products in another order; an element
whose terms nearly cancel keeps the absolute error of the large ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import load_from_jax

from keras_rs_tpu.core import regularizers as jreg
from keras_rs_tpu.layers.feature_interaction import dot_interaction as jdot
from keras_rs_tpu.layers.feature_interaction import feature_cross as jcross
from keras_rs_tpu_torch.core import regularizers as reg_lib
from keras_rs_tpu_torch.core import serialization
from keras_rs_tpu_torch.layers.feature_interaction.dot_interaction import (
    DotInteraction,
)
from keras_rs_tpu_torch.layers.feature_interaction.feature_cross import (
    FeatureCross,
)

DIM = 12


def close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


CROSS_CASES = [
    pytest.param(dict(), id="full"),
    pytest.param(dict(projection_dim=4), id="low_rank"),
    pytest.param(dict(diag_scale=0.5), id="full_diag"),
    pytest.param(dict(use_bias=False, projection_dim=3, diag_scale=0.25),
                 id="low_rank_no_bias_diag"),
    pytest.param(dict(pre_activation="relu", diag_scale=1.0,
                      bias_initializer="random_normal"),
                 id="full_relu_diag"),
    pytest.param(dict(pre_activation="relu", projection_dim=5,
                      kernel_initializer="he_normal"),
                 id="low_rank_relu_he"),
]


def _act(kw, lib):
    kw = dict(kw)
    if kw.get("pre_activation") == "relu":
        kw["pre_activation"] = jax.nn.relu if lib == "jax" else torch.relu
    return kw


def _inputs(seed, rows=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, DIM)).astype(np.float32),
            rng.standard_normal((rows, DIM)).astype(np.float32))


@pytest.mark.parametrize("kw", CROSS_CASES)
def test_feature_cross_forward_and_gradients_match_jax(kw):
    jlayer = jcross.FeatureCross(DIM, key=jax.random.key(3),
                                 **_act(kw, "jax"))
    tlayer = load_from_jax(FeatureCross(DIM, device="cpu",
                                        **_act(kw, "torch")), jlayer)
    assert (tlayer.down_proj_kernel is None) == ("projection_dim" not in kw)
    assert (tlayer.bias is None) == (kw.get("use_bias") is False)
    x0, x = _inputs(4)
    for two_inputs in (False, True):
        def jloss(layer, a, b):
            out = layer(a, b) if two_inputs else layer(a)
            return jnp.sum(out * out), out

        (jval, jout), (jg, jgx0, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jlayer, jnp.asarray(x0), jnp.asarray(x))
        tx0 = torch.tensor(x0, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        tlayer.zero_grad()
        out = tlayer(tx0, tx) if two_inputs else tlayer(tx0)
        (out * out).sum().backward()
        close(out.detach().numpy(), jout)
        close(tx0.grad.numpy(), jgx0)
        if two_inputs:
            close(tx.grad.numpy(), jgx)
        for name, p in tlayer.named_parameters():
            close(p.grad.numpy(), getattr(jg, name), err_msg=name)


def test_feature_cross_full_rank_math():
    layer = FeatureCross(4, diag_scale=0.5, device="cpu")
    x0 = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = x0 * (x0 @ layer.kernel + layer.bias + 0.5 * x0) + x0
        close(layer(x0).numpy(), want.numpy())
    assert layer.kernel.shape == (4, 4)
    low = FeatureCross(8, projection_dim=2, device="cpu")
    assert low.down_proj_kernel.shape == (8, 2) and low.kernel.shape == (2, 8)


@pytest.mark.parametrize("bad", ["diag_scale", "shape"])
def test_feature_cross_errors(bad):
    if bad == "diag_scale":
        with pytest.raises(ValueError, match="non-negative"):
            FeatureCross(4, diag_scale=-1.0, device="cpu")
        with pytest.raises(ValueError, match="non-negative"):
            jcross.FeatureCross(4, key=jax.random.key(0), diag_scale=-1.0)
    else:
        with pytest.raises(ValueError, match="same shape"):
            FeatureCross(4, device="cpu")(torch.ones(2, 4), torch.ones(3, 4))


def test_feature_cross_config_round_trip():
    kw = dict(projection_dim=3, diag_scale=0.5,
              kernel_regularizer=reg_lib.L1L2(0.1, 0.2),
              bias_regularizer=reg_lib.L2(0.3))
    layer = FeatureCross(DIM, device="cpu", name="cross0", **kw)
    jlayer = jcross.FeatureCross(
        DIM, key=jax.random.key(0), projection_dim=3, diag_scale=0.5,
        kernel_regularizer=jreg.L1L2(0.1, 0.2),
        bias_regularizer=jreg.L2(0.3), name="cross0")
    assert layer.get_config() == jlayer.get_config()
    spec = serialization.serialize(layer)
    assert spec["class_name"] == "keras_rs_tpu_torch.layers.FeatureCross"
    restored = serialization.deserialize(spec, device="cpu")
    assert restored.get_config() == layer.get_config()
    assert restored.kernel.shape == layer.kernel.shape
    assert restored._regularizers.keys() == layer._regularizers.keys()


def _np_dot_interaction(feats, self_interaction, skip_gather):
    f = np.stack(feats, axis=1)
    m = f @ f.transpose(0, 2, 1)
    n = m.shape[1]
    if skip_gather:
        k = 0 if self_interaction else -1
        return (m * np.tril(np.ones((n, n)), k=k)).reshape(len(f), -1)
    rows, cols = np.tril_indices(n, k=0 if self_interaction else -1)
    return m[:, rows, cols]


@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("skip_gather", [False, True])
@pytest.mark.parametrize("num_features", [3, 6])
def test_dot_interaction_matches_jax(self_interaction, skip_gather,
                                     num_features):
    feats = [np.random.default_rng(i).normal(size=(5, 4)).astype(np.float32)
             for i in range(num_features)]
    flags = dict(self_interaction=self_interaction, skip_gather=skip_gather)
    layer = DotInteraction(**flags)
    jlayer = jdot.DotInteraction(**flags)
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    out = layer(tf)
    jout = jlayer([jnp.asarray(f) for f in feats])
    assert out.shape == (5, layer.output_dim(num_features))
    assert layer.output_dim(num_features) == jlayer.output_dim(num_features)
    close(out.detach().numpy(), jout)
    close(out.detach().numpy(),
          _np_dot_interaction(feats, self_interaction, skip_gather))
    # Gradients: d sum(out^2) / d feature, against JAX's.
    (out * out).sum().backward()
    jgrads = jax.grad(lambda fs: jnp.sum(jlayer(fs) ** 2))(
        [jnp.asarray(f) for f in feats])
    for t, g in zip(tf, jgrads):
        close(t.grad.numpy(), g)
    # The triangle is built once per feature count and device.
    assert len(layer._triangles) == 1
    layer(tf)
    assert len(layer._triangles) == 1


@pytest.mark.parametrize("bad", ["rank", "shape"])
def test_dot_interaction_checks(bad):
    layer = DotInteraction()
    if bad == "rank":
        with pytest.raises(ValueError, match="rank 2"):
            layer([torch.ones(2, 3), torch.ones(2, 3, 1)])
    else:
        with pytest.raises(ValueError, match="same shape"):
            layer([torch.ones(2, 3), torch.ones(2, 4)])


def test_dot_interaction_config_round_trip():
    layer = DotInteraction(self_interaction=True, skip_gather=True)
    assert layer.get_config() == jdot.DotInteraction(
        self_interaction=True, skip_gather=True).get_config()
    restored = serialization.deserialize(serialization.serialize(layer))
    assert isinstance(restored, DotInteraction)
    assert restored.get_config() == layer.get_config()
