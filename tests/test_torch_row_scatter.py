"""The port's row scatter (B2-B4 plain versions) against the JAX package's
Pallas kernels run in interpret mode on the CPU, at the JAX tests' own
shapes (tests/test_row_ops.py), and the wrappers' dispatch, tail and
argument checks.

Tolerance: none. A scatter copies bytes, so every comparison is
bit-exact (bf16 compared through its uint16 bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)

from keras_rs_tpu.ops import row_ops as jax_row_ops
from keras_rs_tpu_torch.convert import as_tensor
from keras_rs_tpu_torch.ops import row_ops

BLOCK_ROWS = jax_row_ops.BLOCK_ROWS


def _mk(R, N, dim, seed=0, dtype=np.float32):
    """tests/test_row_ops.py::_mk: table, sorted unique idx, rows."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, dim)).astype(dtype)
    idx = np.sort(rng.choice(R, size=N, replace=False)).astype(np.int32)
    rows = rng.standard_normal((N, dim)).astype(dtype)
    return table, idx, rows


def _bits(a) -> np.ndarray:
    """Array bits for a bit-exact comparison (bf16 and f32 alike)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2
                      else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("N", [1, 7, BLOCK_ROWS, BLOCK_ROWS + 5])
def test_scatter_rows_matches_jax_interpret(N):
    table, idx, rows = _mk(3 * BLOCK_ROWS, N, 128)
    want = jax_row_ops.scatter_rows(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(rows),
        interpret=True,
    )
    got = torch.from_numpy(table.copy())
    before = row_ops.scatter_rows.launches
    out = row_ops.scatter_rows(got, torch.from_numpy(idx),
                               torch.from_numpy(rows))
    assert out is got and row_ops.scatter_rows.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("N", [5, BLOCK_ROWS + 3])
def test_multi_scatter_matches_jax_interpret(k, N):
    R, dim = 3 * BLOCK_ROWS, 128
    _, idx, _ = _mk(R, N, dim)
    tables, rows_list = [], []
    for s in range(k):
        t, _, r = _mk(R, N, dim, seed=s + 1)
        tables.append(t)
        rows_list.append(r)
    want = jax_row_ops.scatter_rows_unique_multi(
        [jnp.asarray(t) for t in tables], jnp.asarray(idx),
        [jnp.asarray(r) for r in rows_list], use_pallas=True,
        interpret=True,
    )
    got = [torch.from_numpy(t.copy()) for t in tables]
    row_ops.scatter_rows_unique_multi(
        got, torch.from_numpy(idx), [torch.from_numpy(r) for r in rows_list]
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_multi_scatter_mixed_dtypes_matches_jax_interpret():
    """A bf16 table stream and an f32 slot stream sharing one idx."""
    R, N, dim = 2 * BLOCK_ROWS, 33, 128
    t_bf, idx, r_bf = _mk(R, N, dim, seed=3)
    t_f32, _, r_f32 = _mk(R, N, dim, seed=4)
    jt_bf = jnp.asarray(t_bf).astype(jnp.bfloat16)
    start_bf = np.asarray(jt_bf)  # the kernel donates its tables
    want = jax_row_ops.scatter_rows_unique_multi(
        [jt_bf, jnp.asarray(t_f32)], jnp.asarray(idx),
        [jnp.asarray(r_bf), jnp.asarray(r_f32)], use_pallas=True,
        interpret=True,
    )
    got = [as_tensor(start_bf).clone(), torch.from_numpy(t_f32.copy())]
    row_ops.scatter_rows_unique_multi(
        got, torch.from_numpy(idx),
        [torch.from_numpy(r_bf), torch.from_numpy(r_f32)],
    )
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))


@pytest.mark.parametrize("n_valid", [None, 0, 37, 100])
def test_scatter_row_blocks_matches_jax_interpret(n_valid):
    """tests/test_row_ops.py::test_block_scatter_interpret_matches_xla's
    shape, with the live prefix bounded by n_valid. The Pallas kernel
    writes whole 8-row DMA groups, so past n_valid it may also land up
    to 7 more blocks: it is compared on the rows outside that zone, the
    port's tail rows against the state before the call."""
    rng = np.random.default_rng(3)
    R, N, k, dim = 4096, 100, 2, 128
    packed = rng.standard_normal((R, k, dim)).astype(np.float32)
    idx = np.sort(rng.choice(R, N, replace=False)).astype(np.int32)
    blocks = rng.standard_normal((N, k, dim)).astype(np.float32)
    want = np.asarray(jax_row_ops.scatter_row_blocks(
        jnp.asarray(packed), jnp.asarray(idx), jnp.asarray(blocks),
        None if n_valid is None else jnp.int32(n_valid), interpret=True,
    ))
    got = torch.from_numpy(packed.copy())
    before = row_ops.scatter_row_blocks.launches
    row_ops.scatter_row_blocks(
        got, torch.from_numpy(idx), torch.from_numpy(blocks),
        None if n_valid is None else torch.tensor([n_valid],
                                                  dtype=torch.int32),
    )
    assert row_ops.scatter_row_blocks.launches == before
    got = got.numpy()
    nv = N if n_valid is None else n_valid
    hi = min(-(-nv // 8) * 8, N)
    outside_group = np.ones(R, bool)
    outside_group[idx[nv:hi]] = False
    np.testing.assert_array_equal(_bits(got[outside_group]),
                                  _bits(want[outside_group]))
    np.testing.assert_array_equal(_bits(got[idx[nv:]]),
                                  _bits(packed[idx[nv:]]))


@pytest.mark.parametrize("n_valid", [0, 3, 6])
def test_tail_rows_are_written_back_unchanged(n_valid):
    """Sink padding (duplicates of one row) past n_valid leaves that row
    as it was, in every stream, [R] streams included."""
    table = torch.arange(40.0).view(10, 4)
    acc = torch.arange(10.0)
    idx = torch.tensor([1, 4, 7, 9, 9, 9], dtype=torch.int32)
    rows = -torch.ones(6, 4)
    new_acc = -torch.ones(6)
    t0, a0 = table.clone(), acc.clone()
    row_ops.scatter_rows_unique_multi(
        [table, acc], idx, [rows, new_acc],
        torch.tensor([n_valid], dtype=torch.int32),
    )
    live = idx[:n_valid].long()
    want_t, want_a = t0.clone(), a0.clone()
    want_t[live], want_a[live] = -1.0, -1.0
    assert torch.equal(table, want_t) and torch.equal(acc, want_a)


def test_unique_wrappers_cast_rows_to_the_table_dtype():
    table = torch.zeros(4, 8, dtype=torch.bfloat16)
    x = torch.tensor([[1.0 + 2.0**-9] * 8])  # rounds to nearest: 1.0
    row_ops.scatter_rows_unique(table, torch.tensor([2], dtype=torch.int32),
                                x)
    assert torch.equal(table[2], torch.ones(8, dtype=torch.bfloat16))
    packed = torch.zeros(3, 2, 4)
    row_ops.scatter_row_blocks_unique(
        packed, torch.tensor([1], dtype=torch.int32),
        torch.ones(1, 2, 4, dtype=torch.float64),
    )
    assert packed[1].eq(1).all() and packed.sum() == 8


def _args():
    return dict(tables=[torch.zeros(8, 4)],
                idx=torch.arange(3, dtype=torch.int32),
                rows_list=[torch.zeros(3, 4)])


@pytest.mark.parametrize(
    "bad",
    [
        dict(idx=torch.arange(3)),  # int64 ids
        dict(rows_list=[torch.zeros(3, 5)]),  # width
        dict(rows_list=[torch.zeros(3, 4, dtype=torch.float64)]),  # dtype
        dict(tables=[torch.zeros(8, 4), torch.zeros(9, 4)],
             rows_list=[torch.zeros(3, 4)] * 2),  # row counts differ
        dict(tables=[torch.zeros(8, 4)] * 5,
             rows_list=[torch.zeros(3, 4)] * 5),  # more than 4 streams
        dict(tables=[], rows_list=[]),
        dict(rows_list=[torch.zeros(4, 3).t()]),  # not contiguous
    ],
)
def test_multi_wrapper_rejects_bad_arguments(bad):
    args = {**_args(), **bad}
    with pytest.raises(ValueError):
        row_ops._scatter_rows_multi(args["tables"], args["idx"],
                                    args["rows_list"])


def test_wrappers_reject_bad_n_valid_and_block_shape():
    with pytest.raises(ValueError):
        row_ops.scatter_rows(torch.zeros(8, 4),
                             torch.arange(3, dtype=torch.int32),
                             torch.zeros(3, 4), torch.tensor([3]))
    with pytest.raises(ValueError):
        row_ops.scatter_row_blocks(torch.zeros(8, 4),
                                   torch.arange(3, dtype=torch.int32),
                                   torch.zeros(3, 4))
