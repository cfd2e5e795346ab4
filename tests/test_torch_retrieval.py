"""The port's BruteForceRetrieval and chunked top-k (layers/retrieval,
ops/topk.py) against the JAX package's, on the CPU. Indices must be
equal, ties included (lowest index first, `lax.top_k`'s order); scores
within 1e-6 (one f32 product, summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.retrieval import retrieval as jret
from keras_rs_tpu.ops import topk as jtopk
from keras_rs_tpu_torch.layers.retrieval import retrieval as tret
from keras_rs_tpu_torch.ops import topk as ttopk

TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed, n=1000, d=16, b=8, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # 40 distinct rows, each repeated: every score is tied 25 ways.
        base = rng.standard_normal((40, d)).astype(np.float32)
        cand = base[rng.integers(0, 40, size=n)]
    else:
        cand = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    return queries, cand


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("chunk_size", [None, 256], ids=["direct", "chunked"])
def test_brute_force_matches_jax(ties, chunk_size):
    queries, cand = _data(0, ties=ties)
    jlayer = jret.BruteForceRetrieval(jnp.asarray(cand), k=10,
                                      chunk_size=chunk_size)
    tlayer = tret.BruteForceRetrieval(torch.from_numpy(cand), k=10,
                                      chunk_size=chunk_size)
    j_scores, j_idx = jlayer(jnp.asarray(queries))
    t_scores, t_idx = tlayer(torch.from_numpy(queries))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               **TOL)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_chunked_equals_direct_and_jax(ties):
    queries, cand = _data(1, n=777, ties=ties)  # ragged last chunk
    j_scores, j_idx = jtopk.chunked_topk_mips(jnp.asarray(queries),
                                              jnp.asarray(cand), 7, 128)
    t_scores, t_idx = ttopk.chunked_topk_mips(torch.from_numpy(queries),
                                              torch.from_numpy(cand), 7, 128)
    d_scores, d_idx = ttopk.top_k(
        torch.from_numpy(queries) @ torch.from_numpy(cand).T, 7)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_idx.numpy(), d_idx.numpy())
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores),
                               **TOL)


def test_top_k_breaks_ties_by_lower_index():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0]])
    values, idx = ttopk.top_k(scores, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert values.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_candidate_ids_and_index_only_output():
    queries, cand = _data(2, n=50)
    ids = np.arange(1000, 1050, dtype=np.int32)
    jlayer = jret.BruteForceRetrieval(jnp.asarray(cand), jnp.asarray(ids),
                                      k=5, return_scores=False)
    tlayer = tret.BruteForceRetrieval(torch.from_numpy(cand),
                                      torch.from_numpy(ids), k=5,
                                      return_scores=False)
    np.testing.assert_array_equal(
        tlayer(torch.from_numpy(queries)).numpy(),
        np.asarray(jlayer(jnp.asarray(queries))))


def test_validation_errors():
    cand = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="positive"):
        tret.BruteForceRetrieval(cand, k=0)
    with pytest.raises(ValueError, match="without providing"):
        tret.BruteForceRetrieval(None, torch.arange(4))
    with pytest.raises(ValueError, match="rank 2"):
        tret.BruteForceRetrieval(torch.zeros(4))
    with pytest.raises(ValueError, match="No candidates"):
        tret.BruteForceRetrieval(k=2)(torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="k=5"):
        ttopk.chunked_topk_mips(torch.zeros((1, 3)), cand, 5)
