"""The CUDA row scatter (csrc/row_ops.cu::scatter_rows_kernel, behind B2,
B3 and B4) against its plain PyTorch version on the card. Skips without
a CUDA device; imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_row_scatter_cuda.py

Bound: bit-exact (a copy), and rows outside the live prefix untouched.
"""

import pytest
import torch

from keras_rs_tpu_torch.ops import row_ops

R, N = 4096, 1000
# (dtype, row shape): 16-byte rows (f32 and bf16 at dim 128), 20-byte
# rows (4-byte copies), a 14-byte bf16 row (2-byte copies), [R] f32.
STREAMS = [
    (torch.float32, (128,)),
    (torch.bfloat16, (128,)),
    (torch.float32, ()),
    (torch.bfloat16, (10,)),
    (torch.float32, (5,)),
    (torch.bfloat16, (7,)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(dev, streams, seed, n=N):
    g = torch.Generator(device=dev).manual_seed(seed)
    tables = [torch.randn((R,) + shape, generator=g, device=dev).to(dtype)
              for dtype, shape in streams]
    rows = [torch.randn((n,) + shape, generator=g, device=dev).to(dtype)
            for dtype, shape in streams]
    idx = torch.randperm(R - 1, generator=g, device=dev)[:n].to(torch.int32)
    return tables, rows, idx


def _run(fn, counter, tables, rows, idx, n_valid):
    got = [t.clone() for t in tables]
    want = [t.clone() for t in tables]
    before = counter.launches
    fn(got, idx, rows, n_valid)
    row_ops.scatter_rows_reference(want, idx, rows, n_valid)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    return got, want


def _multi(tables, idx, rows, n_valid):
    if len(tables) == 1:
        return row_ops.scatter_rows(tables[0], idx, rows[0], n_valid)
    return row_ops._scatter_rows_multi(tables, idx, rows, n_valid)


def _check(tables, got, want, idx, nv):
    untouched = torch.ones(R, dtype=torch.bool, device=idx.device)
    untouched[idx[:nv].long()] = False
    for t, g, w in zip(tables, got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        assert torch.equal(g[untouched], t[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("n_valid", [None, 0, 437, N])
def test_streams_match_plain_version(cuda, k, n_valid):
    streams = [STREAMS[(k + s) % len(STREAMS)] for s in range(k)]
    tables, rows, idx = _case(cuda, streams, seed=k)
    nv = None if n_valid is None else torch.tensor(
        [n_valid], dtype=torch.int32, device=cuda)
    counter = row_ops.scatter_rows if k == 1 else row_ops._scatter_rows_multi
    got, want = _run(_multi, counter, tables, rows, idx, nv)
    _check(tables, got, want, idx, N if n_valid is None else n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", STREAMS)
def test_each_row_width_alone(cuda, dtype, shape):
    tables, rows, idx = _case(cuda, [(dtype, shape)], seed=7)
    nv = torch.tensor([600], dtype=torch.int32, device=cuda)
    got, want = _run(_multi, row_ops.scatter_rows, tables, rows, idx, nv)
    _check(tables, got, want, idx, 600)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [None, 300])
def test_row_blocks_match_plain_version(cuda, n_valid):
    """B2 on the packed [R, 3, 128] f32 state, sink-padded."""
    g = torch.Generator(device=cuda).manual_seed(3)
    packed = torch.randn((R, 3, 128), generator=g, device=cuda)
    idx = torch.full((N,), R - 1, dtype=torch.int32, device=cuda)
    live = 300 if n_valid is not None else N
    idx[:live] = torch.randperm(R - 1, generator=g, device=cuda)[:live].to(
        torch.int32)
    blocks = torch.randn((N, 3, 128), generator=g, device=cuda)
    blocks[live:] = packed[R - 1]  # the sink's own bytes (duplicates)
    nv = None if n_valid is None else torch.tensor(
        [n_valid], dtype=torch.int32, device=cuda)
    got, want = packed.clone(), packed.clone()
    before = row_ops.scatter_row_blocks.launches
    row_ops.scatter_row_blocks(got, idx, blocks, nv)
    row_ops.scatter_rows_reference([want], idx, [blocks], nv)
    torch.cuda.synchronize()
    assert row_ops.scatter_row_blocks.launches == before + 1
    _check([packed], [got], [want], idx, live)


@pytest.mark.cuda
def test_duplicate_sink_indices_in_the_tail(cuda):
    """The dedup list's tail repeats the sink; with n_valid the kernel
    skips it, without it every duplicate writes the same bytes."""
    tables, rows, idx = _case(cuda, STREAMS[:2], seed=11)
    idx[700:] = R - 1
    for r in rows:
        r[700:] = 0
    for nv in (torch.tensor([700], dtype=torch.int32, device=cuda), None):
        got, want = _run(_multi, row_ops._scatter_rows_multi, tables, rows,
                         idx, nv)
        _check(tables, got, want, idx, 700 if nv is not None else N)


# Rows narrower than a warp's 32 vectors: one position per 4 (bf16 dim 8,
# f32 dim 16), 8 (bf16 dim 64) or 16 lanes (bf16 dim 128, f32 dim 64).
NARROW = [
    (torch.bfloat16, (8,)),
    (torch.bfloat16, (64,)),
    (torch.bfloat16, (128,)),
    (torch.float32, (16,)),
    (torch.float32, (64,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [None, 601])
@pytest.mark.parametrize("dtype, shape", NARROW)
def test_narrow_rows_share_a_warp(cuda, dtype, shape, n_valid):
    """Several positions per warp, with an odd n and an odd n_valid, so
    the last lane groups of a warp have no position."""
    tables, rows, idx = _case(cuda, [(dtype, shape)], seed=13, n=999)
    nv = None if n_valid is None else torch.tensor(
        [n_valid], dtype=torch.int32, device=cuda)
    got, want = _run(_multi, row_ops.scatter_rows, tables, rows, idx, nv)
    _check(tables, got, want, idx, 999 if n_valid is None else n_valid)


@pytest.mark.cuda
def test_out_of_range_index_in_one_lane_group(cuda):
    """bf16 dim-128 rows: two positions per warp. Positions 4 and 7 are
    out of range; their warp partners 5 and 6 are written all the same."""
    tables, rows, idx = _case(cuda, [(torch.bfloat16, (128,))], seed=17)
    idx[4], idx[7] = -1, R
    got = tables[0].clone()
    row_ops.scatter_rows(got, idx, rows[0])
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < R)
    want = tables[0].clone()
    want[idx[ok].long()] = rows[0][ok]
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(got[idx[5:7].long()], rows[0][5:7])


@pytest.mark.cuda
def test_out_of_range_indices_are_skipped(cuda):
    tables, rows, idx = _case(cuda, STREAMS[:1], seed=5)
    idx[3], idx[9] = -1, R
    got = tables[0].clone()
    row_ops.scatter_rows(got, idx, rows[0])
    torch.cuda.synchronize()
    ok = (idx >= 0) & (idx < R)
    want = tables[0].clone()
    want[idx[ok].long()] = rows[0][ok]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_row_offsets_past_2_to_the_31_bytes(cuda):
    """A 3M x 1,024 f32 view of a 12 GB buffer: rows past 2^31 / 4096 =
    524,288 need 64-bit offsets."""
    big_r, dim = 3_000_000, 1024
    table = torch.zeros((big_r, dim), device=cuda)
    idx = torch.tensor([5, 524_287, 524_288, 2_100_000, big_r - 1],
                       dtype=torch.int32, device=cuda)
    rows = torch.arange(1, 6, device=cuda, dtype=torch.float32)[:, None] \
        .expand(5, dim).contiguous()
    row_ops.scatter_rows(table, idx, rows,
                         torch.tensor([5], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(table[idx.long()], rows)
    assert float(table.sum()) == float(rows.sum())
    del table


@pytest.mark.cuda
def test_cuda_wrapper_rejects_odd_rows_and_empty_calls(cuda):
    before = row_ops.scatter_rows.launches
    with pytest.raises(ValueError, match="2-byte"):
        row_ops.scatter_rows(
            torch.zeros((8, 3), dtype=torch.uint8, device=cuda),
            torch.arange(2, dtype=torch.int32, device=cuda),
            torch.zeros((2, 3), dtype=torch.uint8, device=cuda),
        )
    row_ops.scatter_rows(torch.zeros((8, 4), device=cuda),
                         torch.zeros((0,), dtype=torch.int32, device=cuda),
                         torch.zeros((0, 4), device=cuda))
    with pytest.raises(ValueError):  # mixed devices
        row_ops.scatter_rows(torch.zeros((8, 4), device=cuda),
                             torch.arange(2, dtype=torch.int32),
                             torch.zeros((2, 4), device=cuda))
    assert row_ops.scatter_rows.launches == before
