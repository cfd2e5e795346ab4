"""The port's retrieval layers (hard negative mining, accidental-hit
removal, logQ correction), `recall_target` and the custom-score routing of
BruteForceRetrieval, against the JAX package's, on the CPU. Integer
outputs (ids, positions) are bit-exact, ties included; scores within
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.retrieval import retrieval as jret
from keras_rs_tpu.layers.retrieval.hard_negative_mining import (
    HardNegativeMining as JHardNegativeMining,
)
from keras_rs_tpu.layers.retrieval.remove_accidental_hits import (
    RemoveAccidentalHits as JRemoveAccidentalHits,
)
from keras_rs_tpu.layers.retrieval.sampling_probability_correction import (
    SamplingProbabilityCorrection as JSamplingProbabilityCorrection,
)
from keras_rs_tpu.ops import topk as jtopk
from keras_rs_tpu_torch.layers.retrieval import retrieval as tret
from keras_rs_tpu_torch.layers.retrieval.hard_negative_mining import (
    HardNegativeMining,
)
from keras_rs_tpu_torch.layers.retrieval.remove_accidental_hits import (
    RemoveAccidentalHits,
)
from keras_rs_tpu_torch.layers.retrieval.sampling_probability_correction import (  # noqa: E501
    SamplingProbabilityCorrection,
)
from keras_rs_tpu_torch.ops import topk as ttopk

TOL = dict(rtol=1e-6, atol=1e-6)


def _logits_labels(seed, b=6, n=20, ties=False, multi_positive=False):
    rng = np.random.default_rng(seed)
    if ties:
        logits = rng.integers(-3, 3, size=(b, n)).astype(np.float32)
    else:
        logits = rng.standard_normal((b, n)).astype(np.float32)
    labels = np.zeros((b, n), np.float32)
    labels[np.arange(b), rng.integers(0, n, size=b)] = 1.0
    if multi_positive:
        labels[:, 0] = 1.0
    return logits, labels


@pytest.mark.parametrize("num_hard_negatives", [3, 19, 40])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_hard_negative_mining_matches_jax(num_hard_negatives, ties):
    logits, labels = _logits_labels(0, ties=ties)
    jl, jy = JHardNegativeMining(num_hard_negatives)(jnp.asarray(logits),
                                                      jnp.asarray(labels))
    tl, ty = HardNegativeMining(num_hard_negatives)(
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert ty.sum(dim=1).eq(1).all()  # the positive survives


def test_hard_negative_mining_gradient_reaches_kept_logits():
    logits, labels = _logits_labels(1)
    x = torch.from_numpy(logits).requires_grad_()
    out, _ = HardNegativeMining(4)(x, torch.from_numpy(labels))
    out.sum().backward()
    assert int((x.grad != 0).sum()) == 5 * logits.shape[0]


@pytest.mark.parametrize("ids_kind", ["unique", "duplicated", "tied_labels"])
def test_remove_accidental_hits_matches_jax(ids_kind):
    logits, labels = _logits_labels(2, multi_positive=ids_kind
                                    == "tied_labels")
    rng = np.random.default_rng(3)
    n = logits.shape[1]
    if ids_kind == "unique":
        ids = np.arange(n, dtype=np.int32)
    else:  # repeated ids: several negatives share the positive's id
        ids = rng.integers(0, 5, size=n).astype(np.int32)
    want = JRemoveAccidentalHits()(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(ids))
    got = RemoveAccidentalHits()(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_remove_accidental_hits_2d_ids_and_shape_errors():
    logits, labels = _logits_labels(4)
    ids = np.random.default_rng(5).integers(0, 4, size=logits.shape)
    want = JRemoveAccidentalHits()(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(ids))
    got = RemoveAccidentalHits()(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    layer = RemoveAccidentalHits()
    with pytest.raises(ValueError, match="same shape"):
        layer(torch.zeros((2, 3)), torch.zeros((2, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="last dimensions"):
        layer(torch.zeros((2, 3)), torch.zeros((2, 3)), torch.zeros(4))


def test_sampling_probability_correction_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((4, 9)).astype(np.float32)
    probs = np.concatenate([[0.0, 1e-9, 1.0, 2.0],
                            rng.random(5)]).astype(np.float32)
    want = JSamplingProbabilityCorrection()(jnp.asarray(logits),
                                            jnp.asarray(probs))
    got = SamplingProbabilityCorrection()(torch.from_numpy(logits),
                                          torch.from_numpy(probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert SamplingProbabilityCorrection(1e-3).get_config()["epsilon"] == 1e-3


@pytest.mark.parametrize("chunk_size,n,k", [(8, 300, 10), (100, 777, 7),
                                            (4096, 1000, 5)],
                         ids=["below_k", "unaligned", "above_n"])
def test_chunk_rounding_matches_jax(chunk_size, n, k):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c = rng.standard_normal((n, 16)).astype(np.float32)
    js, ji = jtopk.chunked_topk_mips(jnp.asarray(q), jnp.asarray(c), k,
                                     chunk_size)
    ts, ti = ttopk.chunked_topk_mips(torch.from_numpy(q),
                                     torch.from_numpy(c), k, chunk_size)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("recall_target", [None, 0.95, 0.5])
def test_recall_target_accepted_and_exact(recall_target):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((32, 32)).astype(np.float32)
    c = rng.standard_normal((5000, 32)).astype(np.float32)
    _, exact = jtopk.chunked_topk_mips(jnp.asarray(q), jnp.asarray(c), 10,
                                       512)
    _, got = ttopk.chunked_topk_mips(torch.from_numpy(q),
                                     torch.from_numpy(c), 10, 512,
                                     recall_target=recall_target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exact))
    # The layer takes the reference's argument too.
    layer = tret.BruteForceRetrieval(torch.from_numpy(c), k=10,
                                     chunk_size=512,
                                     recall_target=recall_target)
    np.testing.assert_array_equal(layer(torch.from_numpy(q))[1].numpy(),
                                  np.asarray(exact))


class _JaxCosine(jret.BruteForceRetrieval):
    def compute_score(self, q, c):
        qn = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
        cn = c / jnp.linalg.norm(c, axis=-1, keepdims=True)
        return jnp.matmul(qn, cn.T)


class _Cosine(tret.BruteForceRetrieval):
    def compute_score(self, q, c):
        qn = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        cn = c / torch.linalg.norm(c, dim=-1, keepdim=True)
        return torch.matmul(qn, cn.T)


def test_auto_falls_back_to_direct_for_custom_score():
    rng = np.random.default_rng(0)
    cands = rng.normal(size=(64, 8)).astype(np.float32)
    queries = rng.normal(size=(4, 8)).astype(np.float32)
    jlayer = _JaxCosine(jnp.asarray(cands), k=4)
    jlayer.DIRECT_MAX_CANDIDATES = 16  # the "would chunk" regime
    layer = _Cosine(torch.from_numpy(cands), k=4)
    layer.DIRECT_MAX_CANDIDATES = 16
    js, ji = jlayer(jnp.asarray(queries))
    s, i = layer(torch.from_numpy(queries))
    # Cosine scores are <= 1; the dot-product chunked path would return
    # unnormalized scores > 1 for these magnitudes.
    assert float(s.max()) <= 1.0 + 1e-5
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_explicit_chunk_size_with_custom_score_raises():
    rng = np.random.default_rng(0)
    cands = rng.normal(size=(64, 8)).astype(np.float32)
    layer = _Cosine(torch.from_numpy(cands), k=4, chunk_size=16)
    with pytest.raises(ValueError, match="dot-product"):
        layer(torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)))
    # The base class's own score stays on the chunked path.
    plain = tret.BruteForceRetrieval(torch.from_numpy(cands), k=4,
                                     chunk_size=16)
    assert plain(torch.zeros((1, 8)))[1].shape == (1, 4)
    assert plain.get_config() == {"k": 4, "return_scores": True,
                                  "name": "BruteForceRetrieval"}


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_top_k_orders_signed_zeros_and_extremes_like_lax(dtype):
    x = np.array([[0.8, -1.2, -0.0, 0.0, 0.5, -0.0, np.inf, -np.inf, 1e-45,
                   -1e-45, 6e4, -6e4, 0.0, 0.8]]).astype(dtype)
    jv, ji = jax.lax.top_k(jnp.asarray(x), x.shape[1])
    tv, ti = ttopk.top_k(torch.from_numpy(x), x.shape[1])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.signbit(tv.numpy()),
                                  np.signbit(np.asarray(jv)))
