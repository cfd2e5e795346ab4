"""The port's embedding optimizers against the JAX package's: `apply` on
the same rows, gradients, slots and step (numpy, from a seed), slot
initial values, and lookup by name.

Tolerance: rtol 1e-6, atol 1e-7 (the same f32 formulas; XLA may fuse a
multiply-add or evaluate pow and sqrt to another last bit). FTRL gets
atol 2e-5: its `linear` slot adds sigma * w with sigma =
(acc_new^0.5 - acc^0.5) / lr, so one f32 ulp of a power (1.2e-7 near 1,
measured as the only difference) is multiplied by 1/lr = 20 and by |w|
up to ~4 (measured 5.7e-6), and the new rows divide that by the
quadratic term (measured 1.2e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.embedding import optimizers as jax_opt
from keras_rs_tpu_torch.layers.embedding import optimizers

U, DIM = 50, 32
FTRL_KW = dict(learning_rate=0.05, l1_regularization_strength=0.01,
               l2_regularization_strength=0.02,
               l2_shrinkage_regularization_strength=0.03, beta=0.5)
CASES = [
    ("sgd", dict(learning_rate=0.05)),
    ("adagrad", dict(learning_rate=0.05)),
    ("rowwise_adagrad", dict(learning_rate=0.05)),
    ("adam", dict(learning_rate=0.05)),
    ("ftrl", dict(learning_rate=0.05)),
    ("ftrl", FTRL_KW),
]


def _pair(name, kw):
    return (jax_opt._BY_NAME[name](**kw), optimizers._BY_NAME[name](**kw))


def _inputs(jo, seed):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((U, DIM)).astype(np.float32)
    grads = rng.standard_normal((U, DIM)).astype(np.float32)
    grads[:5] = 0.0  # sink-like rows with zero gradients
    slots = {}
    for name in jo.slot_names:
        shape = (U,) if name in jo.rowwise_slots else (U, DIM)
        v = rng.standard_normal(shape).astype(np.float32)
        # Accumulators are positive; Adam's velocity too.
        if name in ("accumulator", "velocity"):
            v = np.abs(v) + 0.1
        slots[name] = v
    return rows, grads, slots


@pytest.mark.parametrize("step", [0.0, 4.0])
@pytest.mark.parametrize("name, kw", CASES,
                         ids=[f"{n}{'_full' if k is FTRL_KW else ''}"
                              for n, k in CASES])
def test_apply_matches_jax(name, kw, step):
    jo, to = _pair(name, kw)
    assert to.slot_names == jo.slot_names
    assert to.rowwise_slots == jo.rowwise_slots
    assert to.get_config() == jo.get_config()
    rows, grads, slots = _inputs(jo, seed=len(name) + int(step))
    j_rows, j_slots = jo.apply(
        jnp.asarray(rows), jnp.asarray(grads),
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.float32(step),
    )
    t_rows, t_slots = to.apply(
        torch.from_numpy(rows), torch.from_numpy(grads),
        {k: torch.from_numpy(v) for k, v in slots.items()},
        torch.tensor(step),
    )
    assert not np.array_equal(t_rows.numpy()[5:], rows[5:])
    atol = 2e-5 if name == "ftrl" else 1e-7
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(j_rows),
                               rtol=1e-6, atol=atol)
    assert t_slots.keys() == j_slots.keys()
    for k in j_slots:
        assert t_slots[k].shape == j_slots[k].shape
        np.testing.assert_allclose(t_slots[k].numpy(),
                                   np.asarray(j_slots[k]), rtol=1e-6,
                                   atol=atol)


@pytest.mark.parametrize("name", ["adagrad", "rowwise_adagrad", "adam",
                                  "ftrl"])
def test_init_slot_matches_jax(name):
    jo, to = _pair(name, {})
    for slot in to.slot_names:
        shape = (7,) if slot in to.rowwise_slots else (7, DIM)
        np.testing.assert_array_equal(
            to.init_slot(slot, shape).numpy(),
            np.asarray(jo.init_slot(slot, shape)),
        )


def test_get_and_deserialize():
    assert isinstance(optimizers.get("RowWise_Adagrad"),
                      optimizers.RowWiseAdagrad)
    opt = optimizers.deserialize(
        {"class_name": "adam", "config": {"learning_rate": 0.2}})
    assert isinstance(opt, optimizers.Adam) and opt.learning_rate == 0.2
    with pytest.raises(ValueError):
        optimizers.get("lamb")
