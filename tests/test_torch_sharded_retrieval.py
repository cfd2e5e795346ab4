"""The port's ShardedBruteForceRetrieval over D = 2, 4 and 8 gloo CPU
ranks (tests/torch_dist_workers.py) against the JAX package's on a mesh
of the first D of the 8 virtual CPU devices, and against the port's
one-device BruteForceRetrieval; the cases of
tests/test_round2_fixes.py:29-75.

Bounds: the top ids (rows or candidate ids) equal; the scores within
rtol 1e-5 (the same f32 dot products, summed in another order).
"""

import jax
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.parallel import mesh as jmesh
from keras_rs_tpu.parallel.sharded_retrieval import (
    ShardedBruteForceRetrieval as JaxSharded,
)
from keras_rs_tpu_torch.layers.retrieval.retrieval import (
    BruteForceRetrieval,
)


@pytest.fixture(scope="module")
def ranks():
    pools = workers.Pools()
    yield pools
    pools.close()


def _data(n, d=16, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _jax(D, cands, queries, k, ids=None):
    layer = JaxSharded(cands, candidate_ids=ids, k=k,
                       mesh=jmesh.create_mesh(jax.devices()[:D]))
    s, i = layer(queries)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("n", [64, 100, 1000])  # 100: not a multiple of 8
def test_matches_jax_and_one_device(ranks, D, n):
    queries, cands = _data(n)
    want_s, want_i = _jax(D, cands, queries, 10)
    one_s, one_i = BruteForceRetrieval(torch.from_numpy(cands), k=10,
                                       chunk_size=None)(
        torch.from_numpy(queries))
    for r, out in enumerate(ranks(D).run("retrieval_case", cands=cands,
                                         queries=queries, k=10)):
        np.testing.assert_array_equal(out["top"], want_i, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["top"], one_i.numpy())
        np.testing.assert_array_equal(out["top_only"], want_i)
        np.testing.assert_allclose(out["scores"], want_s, rtol=1e-5)
        np.testing.assert_allclose(out["scores"], one_s.numpy(), rtol=1e-5)
        rows = -(-n // D)
        block = np.zeros((rows, cands.shape[1]), np.float32)
        part = cands[r * rows : (r + 1) * rows]
        block[: len(part)] = part
        np.testing.assert_array_equal(out["block"], block)
        assert out["config"]["axis_name"] == "data"
        assert out["config"]["k"] == 10


@pytest.mark.parametrize("D", [2, 8])
def test_candidate_ids_and_their_consistency(ranks, D):
    queries, cands = _data(64)
    ids = np.arange(64, dtype=np.int32) * 7 + 3
    _, want = _jax(D, cands, queries, 5, ids)
    got = ranks(D).run("retrieval_case", cands=cands, queries=queries, k=5,
                       ids=ids, update_without_ids=True)
    for out in got:
        np.testing.assert_array_equal(out["top"], want)
        assert "consistent" in out["error"]


@pytest.mark.parametrize("D", [2, 8])
def test_padding_rows_never_win(ranks, D):
    # 9 candidates on 8 shards: 7 zero rows of padding would win against
    # all-negative scores.
    rng = np.random.default_rng(1)
    cands = -np.abs(rng.normal(size=(9, 8))).astype(np.float32)
    queries = np.abs(rng.normal(size=(4, 8))).astype(np.float32)
    _, want = _jax(D, cands, queries, 9)
    for out in ranks(D).run("retrieval_case", cands=cands, queries=queries,
                            k=9):
        assert int(out["top"].max()) < 9
        np.testing.assert_array_equal(out["top"], want)


def test_k_above_rows_per_shard(ranks):
    # 20 candidates over 8 shards: 3 rows each, k = 10 merges 8 x 3.
    queries, cands = _data(20)
    want_s, want_i = _jax(8, cands, queries, 10)
    for out in ranks(8).run("retrieval_case", cands=cands, queries=queries,
                            k=10):
        assert out["rows_per_shard"] == 3
        np.testing.assert_array_equal(out["top"], want_i)
        np.testing.assert_allclose(out["scores"], want_s, rtol=1e-5)
