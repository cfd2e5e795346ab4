"""The port's ranking metrics (metrics/ranking_metric*.py, ops/ranking.py)
against the JAX package's, on the CPU: the golden inputs of
tests/test_metrics.py with shuffle_ties=False; shuffle_ties=True on
tie-free scores (where the draw cannot matter); seeded lists with masks,
-1 labels and sample weights; and update / merge / result over three
batches against the JAX state. f32 within rtol 1e-5 / atol 1e-6; sorted
indices bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu import metrics as jmetrics
from keras_rs_tpu.ops import ranking as jranking
from keras_rs_tpu_torch.metrics import ranking_metrics as tmetrics
from keras_rs_tpu_torch.ops import ranking as tranking

TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ["DCG", "NDCG", "MeanAveragePrecision", "MeanReciprocalRank",
         "PrecisionAtK", "RecallAtK"]

# The golden inputs of tests/test_metrics.py.
Y_TRUE = np.array([[0, 0, 1, 0], [1, 0, 3, 2], [0, 0, 0, 0], [2, 1, 0, 0]],
                  np.float32)
Y_PRED = np.array([[0.1, 0.2, 0.9, 0.3], [0.1, 0.8, 0.9, 0.7],
                   [0.4, 0.3, 0.2, 0.1], [0.9, 0.7, 0.1, 0.2]], np.float32)


def _pair(name, **kwargs):
    return (getattr(jmetrics, name)(**kwargs),
            getattr(tmetrics, name)(device="cpu", **kwargs))


def _torch(y):
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in y.items()}
            if isinstance(y, dict) else torch.from_numpy(np.asarray(y)))


def _jax(y):
    return ({k: jnp.asarray(v) for k, v in y.items()} if isinstance(y, dict)
            else jnp.asarray(y))


def _compare(name, y_true, y_pred, sample_weight=None, **kwargs):
    jm, tm = _pair(name, **kwargs)
    jm.update_state(_jax(y_true), jnp.asarray(y_pred),
                    None if sample_weight is None
                    else jnp.asarray(sample_weight))
    tm.update_state(_torch(y_true), torch.from_numpy(y_pred),
                    None if sample_weight is None
                    else torch.as_tensor(sample_weight))
    np.testing.assert_allclose(tm.result().numpy(), np.asarray(jm.result()),
                               **TOL)
    return float(tm.result())


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("name", NAMES)
def test_golden_inputs(name, k):
    _compare(name, Y_TRUE, Y_PRED, k=k, shuffle_ties=False)


GOLDEN_CASES = {
    # (name, y_true, y_pred, kwargs, value) from tests/test_metrics.py.
    "mrr_unbatched": ("MeanReciprocalRank", np.array([0.0, 1.0, 0.0]),
                      np.array([0.9, 0.5, 0.3]), {}, 0.5),
    "mrr_mask": ("MeanReciprocalRank",
                 {"labels": np.array([[0.0, 1.0, 0.0]]),
                  "mask": np.array([[True, False, True]])},
                 np.array([[0.9, 0.5, 0.3]]), {}, 0.0),
    "mrr_mask_top": ("MeanReciprocalRank",
                     {"labels": np.array([[1.0, 1.0, 0.0]]),
                      "mask": np.array([[False, True, True]])},
                     np.array([[0.9, 0.5, 0.3]]), {}, 1.0),
    "p_at_2_negative_labels": ("PrecisionAtK",
                               np.array([[1.0, -1.0, 0.0, 1.0]]),
                               np.array([[0.9, 0.8, 0.3, 0.5]]), {"k": 2},
                               1.0),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_golden_cases(case):
    name, y_true, y_pred, kwargs, value = GOLDEN_CASES[case]
    y_true = ({k: v.astype(np.float32) if v.dtype == np.float64 else v
               for k, v in y_true.items()} if isinstance(y_true, dict)
              else y_true.astype(np.float32))
    got = _compare(name, y_true, y_pred.astype(np.float32),
                   shuffle_ties=False, **kwargs)
    np.testing.assert_allclose(got, value, atol=1e-5)


@pytest.mark.parametrize("weight", ["scalar", "per_list", "per_item"])
@pytest.mark.parametrize("name", NAMES)
def test_sample_weights(name, weight):
    sw = {"scalar": 2.0, "per_list": np.array([1.0, 0.0, 0.5, 2.0]),
          "per_item": np.linspace(0.0, 2.0, 16).reshape(4, 4)}[weight]
    _compare(name, Y_TRUE, Y_PRED, np.asarray(sw, np.float32), k=3,
             shuffle_ties=False)


def _lists(seed, b=16, n=10, ties=True):
    """Graded labels in {-1, 0, ..., 3} (-1 invalid), a mask, and scores
    (rounded to one decimal: ties) or tie-free scores."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 4, size=(b, n)).astype(np.float32)
    if ties:
        scores = np.round(rng.standard_normal((b, n)), 1)
    else:
        scores = rng.permutation(b * n).reshape(b, n) / (b * n)
    mask = rng.random((b, n)) > 0.2
    return labels, scores.astype(np.float32), mask


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("name", NAMES)
def test_seeded_lists_masks_and_weights(name, k):
    labels, scores, mask = _lists(NAMES.index(name))
    sw = np.random.default_rng(9).random(16).astype(np.float32)
    _compare(name, {"labels": labels, "mask": mask}, scores, sw, k=k,
             shuffle_ties=False)


@pytest.mark.parametrize("name", NAMES)
def test_shuffle_ties_on_tie_free_scores(name):
    # With no tied valid scores the tie-breaking draw cannot matter, so
    # the torch.Generator draw meets the jax.random one. Weights are
    # positive and nothing is masked: the invalid entries' rewritten
    # scores would tie among themselves (and carry no weight).
    labels, scores, _ = _lists(20 + NAMES.index(name), ties=False)
    labels = np.abs(labels)
    _compare(name, labels, scores, k=5, shuffle_ties=True, seed=3)


@pytest.mark.parametrize("name", NAMES)
def test_update_merge_result_over_three_batches(name):
    jm, tm = _pair(name, k=4, shuffle_ties=False)
    batches = [_lists(30 + i) for i in range(3)]
    js, ts = jm.init_state(), tm.init_state()
    jparts, tparts = [], []
    for labels, scores, mask in batches:
        y = {"labels": labels, "mask": mask}
        js = jm.update(js, _jax(y), jnp.asarray(scores))
        ts = tm.update(ts, _torch(y), torch.from_numpy(scores))
        np.testing.assert_allclose(ts.total.numpy(), np.asarray(js.total),
                                   **TOL)
        np.testing.assert_allclose(ts.count.numpy(), np.asarray(js.count),
                                   **TOL)
        jparts.append(jm.update(jm.init_state(), _jax(y),
                                jnp.asarray(scores)))
        tparts.append(tm.update(tm.init_state(), _torch(y),
                                torch.from_numpy(scores)))
    jmerged = jm.merge(jm.merge(jparts[0], jparts[1]), jparts[2])
    tmerged = tm.merge(tm.merge(tparts[0], tparts[1]), tparts[2])
    np.testing.assert_allclose(tm.result_from_state(tmerged).numpy(),
                               np.asarray(jm.result_from_state(jmerged)),
                               **TOL)
    np.testing.assert_allclose(tm.result_from_state(ts).numpy(),
                               np.asarray(jm.result_from_state(js)), **TOL)


def test_stateful_api_and_config():
    m = tmetrics.PrecisionAtK(k=2, shuffle_ties=False, device="cpu")
    assert float(m.result()) == 0.0
    m.update_state(torch.from_numpy(Y_TRUE), torch.from_numpy(Y_PRED))
    first = float(m.result())
    m.update_state(torch.from_numpy(Y_TRUE), torch.from_numpy(Y_PRED))
    assert abs(float(m.result()) - first) < 1e-6
    m.reset_state()
    assert float(m.result()) == 0.0
    assert tmetrics.NDCG(k=5, shuffle_ties=False, seed=7,
                         device="cpu").get_config() == {
        "k": 5, "shuffle_ties": False, "seed": 7, "name": "NDCG"}
    with pytest.raises(ValueError, match="positive integer"):
        tmetrics.NDCG(k=0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        m.update_state(torch.zeros((2, 2, 2)), torch.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="batch_size"):
        m.update_state(torch.zeros((2, 3)), torch.zeros((2, 3)),
                       torch.ones(3))


def test_shuffle_is_deterministic_per_seed_and_count():
    m = tmetrics.NDCG(seed=3, device="cpu")
    ties_true = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    ties_pred = torch.tensor([[0.5, 0.5, 0.5, 0.5]])
    v1, _ = m.compute(ties_true, ties_pred)
    v2, _ = m.compute(ties_true, ties_pred)
    assert torch.equal(v1, v2)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sort_by_scores_matches_jax(with_mask, k):
    labels, scores, mask = _lists(40)
    jout = jranking.sort_by_scores(
        [jnp.asarray(labels), jnp.arange(10)[None].repeat(16, 0)],
        jnp.asarray(scores), mask=jnp.asarray(mask) if with_mask else None,
        k=k, shuffle_ties=False)
    tout = tranking.sort_by_scores(
        [torch.from_numpy(labels), torch.arange(10)[None].repeat(16, 1)],
        torch.from_numpy(scores),
        mask=torch.from_numpy(mask) if with_mask else None, k=k,
        shuffle_ties=False)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_list_weights_and_dcg_match_jax():
    labels, _, mask = _lists(41)
    labels = np.maximum(labels, 0.0)
    weights = (mask * np.random.default_rng(2).random(mask.shape)).astype(
        np.float32)
    weights[3] = 0.0  # a list with zero weight
    labels[5] = 0.0  # a list with zero relevance
    np.testing.assert_allclose(
        tranking.get_list_weights(torch.from_numpy(weights),
                                  torch.from_numpy(labels)).numpy(),
        np.asarray(jranking.get_list_weights(jnp.asarray(weights),
                                             jnp.asarray(labels))), **TOL)
    np.testing.assert_allclose(
        tranking.compute_dcg(torch.from_numpy(labels),
                             torch.from_numpy(weights)).numpy(),
        np.asarray(jranking.compute_dcg(jnp.asarray(labels),
                                        jnp.asarray(weights))), **TOL)
