"""The port's ranking losses (losses/, ops/pairwise.py, ops/ranking.py)
against the JAX package's, on the CPU: the golden inputs of
tests/test_losses.py, and seeded [8, 12] lists with masks, dict labels,
-1 labels, every reduction and 1-D / 2-D sample weights. f32 within
rtol 1e-5 / atol 1e-6; gradients with respect to the scores too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu import losses as jlosses
from keras_rs_tpu.ops import pairwise as jpairwise
from keras_rs_tpu_torch.losses import list_mle_loss, pairwise_losses
from keras_rs_tpu_torch.losses.base import Loss, unpack_labels_and_mask
from keras_rs_tpu_torch.ops import pairwise as tpairwise

TOL = dict(rtol=1e-5, atol=1e-6)

NAMES = ["PairwiseHingeLoss", "PairwiseLogisticLoss",
         "PairwiseSoftZeroOneLoss", "PairwiseMeanSquaredError", "ListMLELoss"]
REDUCTIONS = ["sum_over_batch_size", "sum", "mean",
              "mean_with_sample_weight", "none"]


def _pair(name, **kwargs):
    module = list_mle_loss if name == "ListMLELoss" else pairwise_losses
    return getattr(jlosses, name)(**kwargs), getattr(module, name)(**kwargs)


# The golden inputs of tests/test_losses.py.
SCORES = np.array([[1.0, 3.0, 2.0, 4.0, 0.8], [1.0, 1.8, 2.0, 3.0, 2.0]],
                  np.float32)
LABELS = np.array([[1.0, 0.0, 1.0, 3.0, 2.0], [0.0, 1.0, 2.0, 3.0, 1.5]],
                  np.float32)
MASK = np.array([[True, True, True, True, True],
                 [True, True, True, False, False]])
GOLDEN = {
    "unbatched": (LABELS[0], SCORES[0], None),
    "batched": (LABELS, SCORES, None),
    "mask": ({"labels": LABELS, "mask": MASK}, SCORES, None),
    "scalar_weight": (LABELS, SCORES, 5.0),
    "itemwise_weight": (LABELS, SCORES, MASK.astype(np.float32)),
}


def _to_jax(y):
    return ({k: jnp.asarray(v) for k, v in y.items()} if isinstance(y, dict)
            else jnp.asarray(y))


def _to_torch(y):
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in y.items()}
            if isinstance(y, dict) else torch.from_numpy(np.asarray(y)))


def _check(name, y_true, y_pred, sw, **kwargs):
    jloss, tloss = _pair(name, **kwargs)
    want = jloss(_to_jax(y_true), jnp.asarray(y_pred),
                 None if sw is None else jnp.asarray(sw))
    got = tloss(_to_torch(y_true), torch.from_numpy(y_pred),
                None if sw is None else torch.as_tensor(sw))
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ListMLE gives one loss per list: item weights do not broadcast against
# it in either package, so those cases are left out.
@pytest.mark.parametrize("name,case", [
    (name, case) for name in NAMES for case in sorted(GOLDEN)
    if not (name == "ListMLELoss" and case == "itemwise_weight")])
def test_golden_inputs(name, case):
    y_true, y_pred, sw = GOLDEN[case]
    _check(name, y_true, y_pred, sw, reduction="none")


@pytest.mark.parametrize("temperature", [0.5, 2.0])
@pytest.mark.parametrize("name", NAMES)
def test_temperature(name, temperature):
    _check(name, LABELS, SCORES, None, temperature=temperature)


def _seeded_lists(seed, b=8, n=12):
    """Graded labels in {-1, 0, ..., 4} (-1 invalid), masks, and scores
    with ties."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 5, size=(b, n)).astype(np.float32)
    labels[0] = -1.0  # a list with no valid item
    scores = np.round(rng.standard_normal((b, n)), 1).astype(np.float32)
    mask = rng.random((b, n)) > 0.2
    return labels, scores, mask


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name,weights", [
    (name, w) for name in NAMES
    for w in ("none", "scalar", "per_list", "per_item")
    if not (name == "ListMLELoss" and w == "per_item")])
def test_seeded_lists(name, reduction, weights):
    labels, scores, mask = _seeded_lists(NAMES.index(name)
                                         + 10 * REDUCTIONS.index(reduction))
    rng = np.random.default_rng(1)
    sw = {"none": None, "scalar": 0.7,
          "per_list": rng.random(8).astype(np.float32),
          "per_item": rng.random((8, 12)).astype(np.float32)}[weights]
    _check(name, {"labels": labels, "mask": mask}, scores, sw,
           reduction=reduction)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name):
    labels, scores, mask = _seeded_lists(3)
    jloss, tloss = _pair(name)
    want = jax.grad(lambda s: jloss(
        {"labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}, s))(
        jnp.asarray(scores))
    x = torch.from_numpy(scores).requires_grad_()
    tloss({"labels": torch.from_numpy(labels),
           "mask": torch.from_numpy(mask)}, x).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


def test_pairwise_ops_match_jax():
    labels, scores, mask = _seeded_lists(4)
    jl, jg = jpairwise.pairwise_comparison(
        jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask),
        jnp.subtract)
    tl, tg = tpairwise.pairwise_comparison(
        torch.from_numpy(labels), torch.from_numpy(scores),
        torch.from_numpy(mask), torch.subtract)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_validation_errors():
    with pytest.raises(ValueError, match="reduction"):
        Loss(reduction="max")
    with pytest.raises(ValueError, match="temperature"):
        pairwise_losses.PairwiseHingeLoss(temperature=0.0)
    with pytest.raises(ValueError, match="temperature"):
        list_mle_loss.ListMLELoss(temperature=-1.0)
    with pytest.raises(ValueError, match="labels"):
        unpack_labels_and_mask({"mask": torch.ones(3)})
    bad = torch.ones((2, 3, 4))
    with pytest.raises(ValueError, match="rank"):
        pairwise_losses.PairwiseHingeLoss()(bad, bad)
    with pytest.raises(ValueError, match="same shape"):
        list_mle_loss.ListMLELoss()(torch.ones((2, 3)), torch.ones((2, 4)))
    assert pairwise_losses.PairwiseHingeLoss(
        temperature=0.7).get_config() == {
        "reduction": "sum_over_batch_size", "name": "PairwiseHingeLoss",
        "temperature": 0.7}
