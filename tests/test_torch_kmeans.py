"""The port's k-means IVF (layers/retrieval/kmeans_retrieval.py) against
the JAX package's, on the CPU: nearest-centroid assignment bit-exact on
well-separated blobs, Lloyd iterations from the centroids the reference
draws (jax.random.choice, which torch cannot reproduce) within 1e-5, and
a JAX-built index carried across by convert.load_kmeans_index giving
identical top ids and scores within 1e-5, in f32 and int8 + reorder.
The port's own index is held to the recall gates of tests/test_ann.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity

from keras_rs_tpu.layers.retrieval import kmeans_retrieval as jkm
from keras_rs_tpu.layers.retrieval.retrieval import (
    BruteForceRetrieval as JBruteForceRetrieval,
)
from keras_rs_tpu_torch import convert
from keras_rs_tpu_torch.layers.retrieval import kmeans_retrieval as tkm
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _blobs(seed, k=6, per=60, dim=8, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, dim)) * 5
    points = np.concatenate(
        [c + rng.normal(size=(per, dim)) * spread for c in centers])
    return points.astype(np.float32), centers.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_clusters_bit_exact_on_blobs(seed):
    points, centers = _blobs(seed)
    centroids = centers + np.float32(0.3)
    want = jkm.assign_clusters(jnp.asarray(points), jnp.asarray(centroids))
    got = tkm.assign_clusters(torch.from_numpy(points),
                              torch.from_numpy(centroids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assign_clusters_ties_take_the_first_centroid():
    centroids = np.array([[1.0, 0.0], [1.0, 0.0], [-1.0, 0.0]], np.float32)
    points = np.array([[2.0, 0.0], [-3.0, 1.0], [0.0, 5.0]], np.float32)
    want = jkm.assign_clusters(jnp.asarray(points), jnp.asarray(centroids))
    got = tkm.assign_clusters(torch.from_numpy(points),
                              torch.from_numpy(centroids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0, 2, 0]


def _reference_init(x, num_clusters, seed):
    """The reference's initial centroids: jax.random.choice's rows."""
    n = x.shape[0]
    idx = jax.random.choice(jax.random.key(seed), n, shape=(num_clusters,),
                            replace=num_clusters > n)
    return np.asarray(x)[np.asarray(idx)]


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("data", ["blobs", "gaussian"])
def test_lloyd_matches_jax_kmeans(data, iterations):
    if data == "blobs":
        x, _ = _blobs(3)
        num_clusters = 6
    else:
        x = np.random.default_rng(4).normal(size=(500, 16)).astype(
            np.float32)
        num_clusters = 12
    want = jkm.kmeans(jnp.asarray(x), num_clusters, key=jax.random.key(7),
                      iterations=iterations)
    got = tkm.lloyd(torch.from_numpy(x),
                    torch.from_numpy(_reference_init(x, num_clusters, 7)),
                    iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lloyd_keeps_empty_clusters_and_chunks():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(70_000, 2)).astype(np.float32)  # two chunks
    init = np.array([[0.0, 0.0], [1.0, 1.0], [1e4, 1e4]], np.float32)
    got = tkm.lloyd(torch.from_numpy(x), torch.from_numpy(init), 1)
    assign = np.argmin(((x[:, None] - init[None]) ** 2).sum(-1), axis=1)
    for c in range(2):
        np.testing.assert_allclose(got[c].numpy(),
                                   x[assign == c].mean(axis=0), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), init[2])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_jax_index_carried_across(quantize):
    rng = np.random.default_rng(6)
    cands = rng.normal(size=(600, 16)).astype(np.float32)
    queries = rng.normal(size=(12, 16)).astype(np.float32)
    ids = (np.arange(600) * 3 + 1).astype(np.int32)
    jlayer = jkm.KMeansRetrieval(jnp.asarray(cands), jnp.asarray(ids), k=7,
                                 num_clusters=15, num_probes=5,
                                 quantize=quantize, reorder_k=20)
    tlayer = tkm.KMeansRetrieval(k=7, num_probes=5, quantize=quantize,
                                 reorder_k=20, device="cpu")
    convert.load_kmeans_index(tlayer, torch_parity.jax_kmeans_index(jlayer))
    assert tlayer.cluster_candidates.dtype == (
        torch.int8 if quantize else torch.float32)
    js, ji = jlayer(jnp.asarray(queries))
    ts, ti = tlayer(torch.from_numpy(queries))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def _recall(got, want):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / len(b)
                    for a, b in zip(got, want)])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_port_index_recall_vs_brute_force(quantize):
    rng = np.random.default_rng(1)
    candidates = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(32, 16)).astype(np.float32)
    _, exact = JBruteForceRetrieval(jnp.asarray(candidates), k=10)(
        jnp.asarray(queries))
    ann = tkm.KMeansRetrieval(torch.from_numpy(candidates), k=10,
                              num_clusters=40, num_probes=10,
                              quantize=quantize, device="cpu")
    _, ids = ann(torch.from_numpy(queries))
    assert _recall(ids.numpy(), np.asarray(exact)) > 0.8


def test_port_index_full_probe_is_exact_with_custom_ids():
    rng = np.random.default_rng(2)
    candidates = rng.normal(size=(300, 8)).astype(np.float32)
    queries = rng.normal(size=(8, 8)).astype(np.float32)
    ids = torch.arange(299, -1, -1)
    ann = tkm.KMeansRetrieval(torch.from_numpy(candidates), ids, k=5,
                              num_clusters=10, num_probes=10, device="cpu")
    scores, got = ann(torch.from_numpy(queries))
    want_s, want_i = BruteForceRetrieval(torch.from_numpy(candidates), ids,
                                         k=5)(torch.from_numpy(queries))
    np.testing.assert_array_equal(got.numpy(), want_i.numpy())
    np.testing.assert_allclose(scores.numpy(), want_s.numpy(), **TOL)
    assert ann.cluster_valid.sum() == 300
    assert ann.cluster_candidates.shape[:2] == ann.cluster_valid.shape


def test_int8_reorder_returns_exact_scores_and_config():
    rng = np.random.default_rng(0)
    cands = rng.normal(size=(1000, 32)).astype(np.float32)
    queries = rng.normal(size=(8, 32)).astype(np.float32)
    layer = tkm.KMeansRetrieval(torch.from_numpy(cands), k=5,
                                num_clusters=20, num_probes=6,
                                quantize="int8", reorder_k=20, seed=3,
                                device="cpu")
    assert layer.cluster_candidates.dtype == torch.int8
    scores, ids = layer(torch.from_numpy(queries))
    full = queries @ cands.T
    np.testing.assert_allclose(
        scores.numpy(), np.take_along_axis(full, ids.numpy(), 1), **TOL)
    cfg = layer.get_config()
    assert cfg["quantize"] == "int8" and cfg["reorder_k"] == 20
    assert cfg["seed"] == 3 and cfg["num_probes"] == 6
    assert layer(torch.from_numpy(queries))[1].equal(ids)
    with pytest.raises(ValueError, match="Unsupported quantize"):
        tkm.KMeansRetrieval(quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="No candidates"):
        tkm.KMeansRetrieval(device="cpu")(torch.zeros((1, 32)))
    with pytest.raises(ValueError, match="int8"):
        tkm.KMeansRetrieval(device="cpu").set_index(
            layer.centroids, layer.cluster_candidates, layer.cluster_ids,
            layer.cluster_valid, layer.cluster_scales, layer.cluster_pos,
            layer.flat_candidates)
