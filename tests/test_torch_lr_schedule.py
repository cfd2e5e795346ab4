"""Callable embedding learning rates (a schedule of the stack's step
counter) against the JAX package, on the CPU: the packed DLRM (f32 +
Adagrad, the state kernel B1 updates; its plain version runs here) and
the split layout (f32 + row-wise Adagrad), 3 steps each from identical
parameters. The schedule is one Python function that both packages call
with their 0-dim f32 step.

Tolerance: losses and tables within 1e-5, as the f32 DLRM tests
(test_torch_dlrm.py) hold them.
"""

import numpy as np
import pytest
import torch
from torch_parity import (
    B,
    LR,
    MULTI_HOT,
    VOCAB,
    build_pair,
    train_jax,
    train_torch,
)

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.layers.embedding.config import TableConfig
from keras_rs_tpu_torch.layers.embedding.stacking import _optimizer_key

F32 = dict(compute_dtype=None, dense_output_dtype="float32")


def schedule(step):
    """Halves the rate every two steps (step 0, 1, 2 -> 1, 0.71, 0.5)."""
    return 4 * LR * 0.5 ** (step / 2.0)


def _batch(seed):
    return synthetic.criteo_like_batch(
        B, vocab_sizes=VOCAB, multi_hot_sizes=MULTI_HOT, seed=seed)


@pytest.mark.parametrize("layout, overrides", [
    ("packed", dict(embedding_optimizer="adagrad")),
    ("split", dict(embedding_optimizer="rowwise_adagrad")),
])
def test_schedule_three_steps_match_jax(layout, overrides):
    kw = dict(F32, learning_rate=schedule, **overrides)
    jmodel, tmodel = build_pair(seed=4, **kw)
    stack = tmodel.embedding_layer.stacks[0]
    assert stack.packed_state == (layout == "packed")
    assert callable(stack.optimizer.learning_rate)
    batches = [_batch(s) for s in (20, 21, 20)]
    j_losses, j_after = train_jax(jmodel, LR, batches)
    t_losses = train_torch(tmodel, LR, batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-5)
    j_tables = j_after.embedding_layer.get_embedding_tables()
    t_tables = tmodel.embedding_layer.get_embedding_tables()
    for name, t in t_tables.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(j_tables[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # The schedule moved the tables off a constant-rate run.
    _, const = build_pair(seed=4, **dict(kw, learning_rate=4 * LR))
    train_torch(const, LR, batches)
    moved = const.embedding_layer.get_embedding_tables()
    assert any(not torch.equal(moved[n], t) for n, t in t_tables.items())


def test_schedule_is_evaluated_on_the_step_tensor():
    opt = opt_lib.SGD(learning_rate=schedule)
    step = torch.tensor(2.0)
    lr = opt.lr(step)
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    np.testing.assert_allclose(float(lr), 2 * LR, rtol=1e-7)
    const = opt_lib.SGD(learning_rate=lambda s: 0.25)  # a Python number
    with pytest.raises(TypeError, match="must return a tensor"):
        const.lr(step)
    rows, grads = torch.ones(2, 4), torch.ones(2, 4)
    new, _ = opt.apply(rows, grads, {}, step)
    np.testing.assert_allclose(new.numpy(), 1 - 2 * LR, rtol=1e-6)
    with pytest.raises(ValueError, match="cannot be serialized"):
        opt.get_config()
    assert opt_lib.SGD(0.1).get_config() == {"learning_rate": 0.1}


def test_tables_stack_only_with_the_same_schedule():
    other = lambda step: schedule(step)  # noqa: E731

    def key(lr):
        return _optimizer_key(TableConfig(
            "t", 10, 8, optimizer=opt_lib.Adagrad(learning_rate=lr)))

    assert key(schedule) == key(schedule)
    assert key(schedule) != key(other)
    assert key(0.1) == key(0.1)
