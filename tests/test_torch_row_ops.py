"""The port's fused apply + row-block scatter against the JAX package's
Pallas kernel (run in interpret mode on the CPU, as tests/test_row_ops.py
runs it), and the wrapper's dispatch and argument checks.

Tolerance: updated rows within rtol 1e-6 (the same Adagrad formula in
f32; XLA may fuse the multiply-add differently), untouched rows
bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.layers.embedding import optimizers as jax_opt
from keras_rs_tpu.ops import row_ops as jax_row_ops
from keras_rs_tpu_torch.layers.embedding import optimizers
from keras_rs_tpu_torch.ops import row_ops

R, N, DIM = 2048, 1000, 128
LR = 0.05


def _jax_adagrad_apply():
    """The apply_fn the JAX lookup traces into its kernel (lookup.py)."""
    opt = jax_opt.Adagrad(learning_rate=LR)

    def rmw_apply(blk_t, grads_t, scalars):
        rows, acc = opt.apply(
            blk_t[:, 0], grads_t, {"accumulator": blk_t[:, 1]}, scalars[0]
        )
        return [rows, acc["accumulator"]]

    return rmw_apply


_RMW_APPLY = _jax_adagrad_apply()  # static argument: one object, one trace


def _inputs(seed):
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((R, 2, DIM)).astype(np.float32)
    packed[:, 1] = np.abs(packed[:, 1]) + 0.1  # accumulator > 0
    idx = np.sort(rng.choice(R, N, replace=False)).astype(np.int32)
    grads = rng.standard_normal((N, DIM)).astype(np.float32)
    return packed, idx, grads


@pytest.mark.parametrize("n_valid", [0, 437, N])
def test_apply_scatter_matches_jax_interpret(n_valid):
    packed, idx, grads = _inputs(seed=n_valid)
    step = np.float32(3.0)
    want = np.asarray(
        jax_row_ops.apply_scatter_row_blocks(
            jnp.asarray(packed),
            jnp.asarray(idx),
            jnp.asarray(packed[idx]),
            jnp.asarray(grads),
            jnp.asarray([step]),
            _RMW_APPLY,
            jnp.int32(n_valid),
            interpret=True,
        )
    )
    got = torch.from_numpy(packed.copy())
    row_ops.apply_scatter_row_blocks(
        got,
        torch.from_numpy(idx),
        torch.from_numpy(grads),
        torch.tensor([step]),
        optimizers.Adagrad(learning_rate=LR),
        torch.tensor([n_valid], dtype=torch.int32),
    )
    got = got.numpy()
    live = idx[:n_valid]
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=1e-7)
    if n_valid:
        assert not np.array_equal(got[live], packed[live])
    # Every row outside the live prefix is untouched by the port. (The
    # Pallas kernel may also write a few rows past n_valid, up to its
    # 8-row DMA group: compare it only outside that zone.)
    untouched = np.ones(R, bool)
    untouched[live] = False
    np.testing.assert_array_equal(got[untouched], packed[untouched])
    hi = min(-(-n_valid // 8) * 8, N)
    beyond = np.ones(R, bool)
    beyond[idx[:hi]] = False
    np.testing.assert_array_equal(want[beyond], packed[beyond])


def test_zero_gradient_leaves_sink_row_unchanged():
    """The lookup relies on it: sink padding carries zero gradients, so
    a tail write (if any) is an identity for Adagrad and SGD."""
    for opt, k in ((optimizers.Adagrad(learning_rate=LR), 2),
                   (optimizers.SGD(learning_rate=LR), 1)):
        packed = torch.rand((4, k, DIM)) + 0.1
        before = packed.clone()
        row_ops.apply_scatter_row_blocks(
            packed,
            torch.tensor([3, 3], dtype=torch.int32),
            torch.zeros((2, DIM)),
            torch.zeros(1),
            opt,
            torch.tensor([2], dtype=torch.int32),
        )
        assert torch.equal(packed, before)


def _args():
    packed = torch.zeros((8, 2, DIM))
    return dict(
        packed=packed,
        idx=torch.arange(4, dtype=torch.int32),
        grads=torch.zeros((4, DIM)),
        scalars=torch.zeros(1),
        optimizer=optimizers.Adagrad(learning_rate=LR),
        n_valid=torch.tensor([4], dtype=torch.int32),
    )


@pytest.mark.parametrize(
    "bad",
    [
        dict(packed=torch.zeros((8, 2, DIM), dtype=torch.float64)),
        dict(packed=torch.zeros((8, 3, DIM))),  # k != 1 + slots
        dict(idx=torch.arange(4)),  # int64 ids
        dict(grads=torch.zeros((4, DIM - 1))),
        dict(n_valid=torch.tensor([4])),  # int64 count
        dict(grads=torch.zeros((DIM, 4)).t()),  # not contiguous
    ],
)
def test_wrapper_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        row_ops.apply_scatter_row_blocks(**{**_args(), **bad})


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = row_ops.apply_scatter_row_blocks.launches
    row_ops.apply_scatter_row_blocks(**_args())
    assert row_ops.apply_scatter_row_blocks.launches == before
