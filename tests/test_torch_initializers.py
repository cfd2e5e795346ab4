"""The port's initializers (core/initializers.py) against the JAX
package's: names, configs and serialized forms equal; draws checked by
their moments and bounds at a large shape (torch.Generator and
jax.random give different numbers from one seed, so values are not
compared). Also the `Embedding` layer's random_normal default and
SASRec's initial parameters, which the default does not change.

Bounds at 400,000 draws: means within 0.01 of the scale, standard
deviations within 1%, uniform and truncated draws inside their limits.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.core import initializers as jinit
from keras_rs_tpu_torch.core import initializers as init
from keras_rs_tpu_torch.layers.attention import Embedding
from keras_rs_tpu_torch.models.sasrec import SASRec

SHAPE = (800, 500)  # fan_in 800, fan_out 500, fan_avg 650
FANS = {"fan_in": 800, "fan_out": 500, "fan_avg": 650}
TRUNC = 0.87962566103423978  # stddev of a unit normal cut to [-2, 2]


def _draw(initializer, shape=SHAPE, seed=0):
    return initializer(shape, torch.float32, "cpu",
                       torch.Generator().manual_seed(seed)).numpy()


def _expect(name, config):
    """(mean, stddev, bound) of the distribution the JAX initializer
    draws; bound None where the draws are unbounded."""
    if name == "zeros":
        return 0.0, 0.0, 0.0
    if name == "ones":
        return 1.0, 0.0, 1.0
    if name == "constant":
        return config["value"], 0.0, abs(config["value"])
    if name == "random_uniform":
        lo, hi = config["minval"], config["maxval"]
        return (lo + hi) / 2, (hi - lo) / math.sqrt(12), max(-lo, hi)
    if name == "random_normal":
        return config["mean"], config["stddev"], None
    if name == "truncated_normal":
        return (config["mean"], config["stddev"] * TRUNC,
                abs(config["mean"]) + 2 * config["stddev"])
    scale, mode, dist = (config["scale"], config["mode"],
                         config["distribution"])
    std = math.sqrt(scale / FANS[mode])
    if dist == "uniform":
        return 0.0, std, math.sqrt(3) * std
    if dist == "truncated_normal":
        return 0.0, std, 2 * std / TRUNC
    return 0.0, std, None


CASES = [
    ("zeros", init.Zeros(), jinit.Zeros(), {}),
    ("ones", init.Ones(), jinit.Ones(), {}),
    ("constant", init.Constant(0.3), jinit.Constant(0.3), {"value": 0.3}),
    ("random_uniform", init.RandomUniform(-0.2, 0.1),
     jinit.RandomUniform(-0.2, 0.1), {"minval": -0.2, "maxval": 0.1}),
    ("random_normal", init.RandomNormal(0.1, 0.2),
     jinit.RandomNormal(0.1, 0.2),
     {"mean": 0.1, "stddev": 0.2}),
    ("truncated_normal", init.TruncatedNormal(-0.1, 0.3),
     jinit.TruncatedNormal(-0.1, 0.3), {"mean": -0.1, "stddev": 0.3}),
] + [
    ("variance_scaling", init.VarianceScaling(s, m, d),
     jinit.VarianceScaling(s, m, d),
     {"scale": s, "mode": m, "distribution": d})
    for s, m, d in [(1.0, "fan_in", "truncated_normal"),
                    (2.0, "fan_out", "normal"),
                    (0.5, "fan_avg", "untruncated_normal"),
                    (3.0, "fan_in", "uniform")]
] + [
    (name, cls(), jcls(), {"scale": s, "mode": m, "distribution": d})
    for name, cls, jcls, (s, m, d) in [
        ("glorot_uniform", init.GlorotUniform, jinit.GlorotUniform,
         (1.0, "fan_avg", "uniform")),
        ("glorot_normal", init.GlorotNormal, jinit.GlorotNormal,
         (1.0, "fan_avg", "truncated_normal")),
        ("he_uniform", init.HeUniform, jinit.HeUniform,
         (2.0, "fan_in", "uniform")),
        ("he_normal", init.HeNormal, jinit.HeNormal,
         (2.0, "fan_in", "truncated_normal")),
    ]
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


@pytest.mark.parametrize("name, ours, theirs, config", CASES, ids=IDS)
def test_moments_and_bounds(name, ours, theirs, config):
    x = _draw(ours)
    assert x.shape == SHAPE and x.dtype == np.float32
    x = x.astype(np.float64)
    mean, std, bound = _expect(name, config)
    assert abs(x.mean() - mean) <= 0.01 * max(std, 1e-3) + 1e-7
    np.testing.assert_allclose(x.std(), std, rtol=0.01, atol=1e-7)
    if bound is not None:
        assert np.abs(x).max() <= bound * (1 + 1e-6) + 1e-7
    # The JAX draw of the same initializer has the same moments.
    j = np.asarray(theirs(jax.random.key(0), SHAPE), np.float64)
    assert abs(j.mean() - mean) <= 0.01 * max(std, 1e-3) + 1e-7
    np.testing.assert_allclose(j.std(), std, rtol=0.01, atol=1e-7)
    # A generator seed fixes the draw.
    np.testing.assert_array_equal(x, _draw(ours).astype(np.float64))


@pytest.mark.parametrize("name, ours, theirs, config", CASES, ids=IDS)
def test_config_and_serialize_round_trip(name, ours, theirs, config):
    assert ours.get_config() == theirs.get_config()
    spec = init.serialize(ours)
    assert spec == jinit.serialize(theirs)
    back = init.deserialize(spec)
    assert type(back) is type(ours)
    assert back.get_config() == ours.get_config()
    np.testing.assert_array_equal(_draw(back, (50, 40)),
                                  _draw(ours, (50, 40)))


@pytest.mark.parametrize("name", sorted(init._ALIASES))
def test_get_by_name(name):
    ours = init.get(name)
    assert type(ours).__name__ == type(jinit.get(name)).__name__
    assert init.get(name.upper()).get_config() == ours.get_config()
    assert init.deserialize(name).get_config() == ours.get_config()
    assert init.get(ours) is ours


def test_get_rejects_unknown_and_passes_callables():
    with pytest.raises(ValueError, match="Unknown initializer"):
        init.get("orthogonal")
    with pytest.raises(ValueError, match="Unknown initializer"):
        jinit.get("orthogonal")
    fn = lambda shape, *a, **k: torch.zeros(shape)  # noqa: E731
    assert init.get(fn) is fn
    with pytest.raises(ValueError, match="Invalid `distribution`"):
        init.VarianceScaling(distribution="cauchy")


def test_fan_shape_scales_a_chunk_like_the_whole_table():
    x = init.VarianceScaling(1.0, "fan_out", "normal")(
        (1000, 64), generator=torch.Generator().manual_seed(1),
        fan_shape=(10_000, 16)).numpy()
    np.testing.assert_allclose(x.std(), math.sqrt(1 / 16), rtol=0.02)


def test_embedding_defaults_to_random_normal():
    e = Embedding(2000, 64, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    x = e.embeddings.detach().numpy()
    assert abs(x.mean()) < 1e-3
    np.testing.assert_allclose(x.std(), 0.05, rtol=0.01)
    want = init.RandomNormal()((2000, 64), torch.float32, "cpu",
                               torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(x, want)
    g = Embedding(2000, 64, embeddings_initializer="glorot_uniform",
                  generator=torch.Generator().manual_seed(0), device="cpu")
    assert np.abs(g.embeddings.detach().numpy()).max() <= math.sqrt(
        6 / 2064)


def test_sasrec_initial_parameters_unchanged():
    """SASRec names Glorot-uniform for its item table, so the Embedding
    default leaves its draws as they were: item table first, position
    table second, from the one generator."""
    model = SASRec(40, num_layers=1, hidden_dim=16, max_sequence_length=12,
                   generator=torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(5)
    glorot = init.GlorotUniform()
    item = glorot((41, 16), torch.float32, "cpu", g)
    pos = glorot((12, 16), torch.float32, "cpu", g)
    wq = glorot((16, 16), torch.float32, "cpu", g)
    assert torch.equal(model.item_embedding.embeddings.detach(), item)
    assert torch.equal(model.position_embedding.embeddings.detach(), pos)
    assert torch.equal(model.blocks[0].attention.wq.detach(), wq)
