"""The CUDA row kernel (csrc/row_ops.cu) against its plain PyTorch
version on the card. Skips without a CUDA device; imports no JAX, so it
runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_row_ops_cuda.py

Bound: 4 f32 ulp relative on updated rows (the kernel is built with
-fmad=false, so each operation rounds once in the plain version's order;
expected exact), untouched rows bit-exact.
"""

import pytest
import torch

from keras_rs_tpu_torch.layers.embedding import optimizers
from keras_rs_tpu_torch.ops import row_ops

R, N, DIM = 2048, 1000, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "opt, k",
    [(optimizers.Adagrad(learning_rate=0.05), 2),
     (optimizers.SGD(learning_rate=0.05), 1)],
    ids=["adagrad", "sgd"],
)
@pytest.mark.parametrize("n_valid", [0, 437, N])
def test_cuda_kernel_matches_plain_version(cuda, opt, k, n_valid):
    g = torch.Generator(device=cuda).manual_seed(n_valid)
    packed = torch.rand((R, k, DIM), generator=g, device=cuda) + 0.1
    idx = torch.randperm(R, generator=g, device=cuda)[:N].to(torch.int32)
    args = (
        idx,
        torch.randn((N, DIM), generator=g, device=cuda),
        torch.tensor([3.0], device=cuda),
        opt,
        torch.tensor([n_valid], dtype=torch.int32, device=cuda),
    )
    got, want = packed.clone(), packed.clone()
    before = row_ops.apply_scatter_row_blocks.launches
    row_ops.apply_scatter_row_blocks(got, *args)
    row_ops.apply_scatter_row_blocks_reference(want, *args)
    torch.cuda.synchronize()
    assert row_ops.apply_scatter_row_blocks.launches == before + 1
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=1e-12)
    untouched = torch.ones(R, dtype=torch.bool, device=cuda)
    untouched[idx[:n_valid].long()] = False
    assert torch.equal(got[untouched], packed[untouched])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        row_ops.apply_scatter_row_blocks(
            torch.zeros((8, 2, DIM), device=cuda),
            torch.arange(4, dtype=torch.int32),  # on the CPU
            torch.zeros((4, DIM), device=cuda),
            torch.zeros(1, device=cuda),
            optimizers.Adagrad(),
            torch.tensor([4], dtype=torch.int32, device=cuda),
        )


@pytest.mark.cuda
def test_cuda_wrapper_rejects_misaligned_state(cuda):
    # A contiguous view one float into its storage: float4 loads would
    # fault, so the wrapper raises before the launch.
    packed = torch.zeros(8 * 2 * DIM + 1, device=cuda)[1:].view(8, 2, DIM)
    before = row_ops.apply_scatter_row_blocks.launches
    with pytest.raises(ValueError, match="16-byte"):
        row_ops.apply_scatter_row_blocks(
            packed,
            torch.arange(4, dtype=torch.int32, device=cuda),
            torch.zeros((4, DIM), device=cuda),
            torch.zeros(1, device=cuda),
            optimizers.Adagrad(),
            torch.tensor([4], dtype=torch.int32, device=cuda),
        )
    assert row_ops.apply_scatter_row_blocks.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adagrad", "sgd"])
def test_cuda_kernel_reads_a_schedule_from_the_device(cuda, name):
    """A callable learning rate is evaluated at the step counter on the
    device and read by the kernel from its scalars buffer: no host sync
    (sync-debug "error"), the plain version's rows."""
    cls = {"adagrad": optimizers.Adagrad, "sgd": optimizers.SGD}[name]
    k = 2 if name == "adagrad" else 1
    opt = cls(learning_rate=lambda step: 0.05 * 0.5 ** step)
    g = torch.Generator(device=cuda).manual_seed(5)
    packed = torch.rand((R, k, DIM), generator=g, device=cuda) + 0.1
    idx = torch.randperm(R, generator=g, device=cuda)[:N].to(torch.int32)
    args = (idx, torch.randn((N, DIM), generator=g, device=cuda),
            torch.tensor([3.0], device=cuda), opt,
            torch.tensor([N], dtype=torch.int32, device=cuda))
    got, want = packed.clone(), packed.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        row_ops.apply_scatter_row_blocks(got, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    row_ops.apply_scatter_row_blocks_reference(want, *args)
    torch.testing.assert_close(got, want, rtol=4 * 2.0**-23, atol=1e-12)
    const = packed.clone()
    row_ops.apply_scatter_row_blocks(const, idx, args[1], args[2],
                                     cls(learning_rate=0.05), args[4])
    assert not torch.equal(const, got)  # the rate at step 3 was used


# --- The split update of bf16 tables (apply_split_rows, round_split_rows):
# bit for bit with the plain version (-fmad=false, the plain version's
# order of sums and correctly rounded square root).

SEED = 0x5EED << 32


def _split_case(cuda, dim: int, nv: int, seed: int = 0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    table = torch.randn((R, dim), generator=g, device=cuda).to(torch.bfloat16)
    acc = torch.rand(R, generator=g, device=cuda) + 0.1
    idx = torch.full((N,), R - 1, dtype=torch.int32, device=cuda)
    idx[:nv] = torch.randperm(R - 1, generator=g, device=cuda)[:nv].int()
    grads = torch.randn((N, dim), generator=g, device=cuda) * 0.1
    grads[nv:] = 0.0
    return table, acc, idx, grads, torch.tensor([nv], dtype=torch.int32,
                                                 device=cuda)


def _live_bits_equal(got, want, nv):
    return torch.equal(got[:nv].view(torch.int16), want[:nv].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 256, 64, 50, 600])
@pytest.mark.parametrize("nv", [0, 437, N])
def test_cuda_split_kernel_matches_plain_version(cuda, dim, nv):
    table, acc, idx, grads, n_valid = _split_case(cuda, dim, nv)
    opt = optimizers.RowWiseAdagrad(learning_rate=0.05)
    step = torch.tensor([7.0], device=cuda)
    got_acc, want_acc = acc.clone(), acc.clone()
    before = row_ops.apply_split_rows.launches
    got = row_ops.apply_split_rows(table, got_acc, idx, grads, step, opt,
                                   n_valid, SEED)
    want = row_ops.apply_split_rows_reference(table, want_acc, idx, grads,
                                              step, opt, n_valid, SEED)
    torch.cuda.synchronize()
    assert row_ops.apply_split_rows.launches == before + 1
    assert _live_bits_equal(got, want, nv)
    assert torch.equal(got_acc.view(torch.int32), want_acc.view(torch.int32))
    untouched = torch.ones(R, dtype=torch.bool, device=cuda)
    untouched[idx[:nv].long()] = False
    assert torch.equal(got_acc[untouched], acc[untouched])


@pytest.mark.cuda
def test_cuda_split_kernel_reads_step_and_schedule_from_the_device(cuda):
    """No host sync (sync-debug "error"); the step keys the bits and a
    schedule's rate is read from the scalars buffer."""
    table, acc, idx, grads, n_valid = _split_case(cuda, 128, N, seed=3)
    opt = optimizers.RowWiseAdagrad(learning_rate=lambda s: 0.05 * 0.5 ** s)
    step = torch.tensor([3.0], device=cuda)
    got_acc, want_acc = acc.clone(), acc.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = row_ops.apply_split_rows(table, got_acc, idx, grads, step, opt,
                                       n_valid, SEED)
        rounded = row_ops.round_split_rows(grads, idx, step, n_valid, SEED)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = row_ops.apply_split_rows_reference(table, want_acc, idx, grads,
                                              step, opt, n_valid, SEED)
    assert _live_bits_equal(got, want, N)
    assert torch.equal(got_acc, want_acc)
    assert _live_bits_equal(rounded, row_ops.round_split_rows_reference(
        grads, idx, step, n_valid, SEED), N)
    later = row_ops.round_split_rows(grads, idx, step + 1, n_valid, SEED)
    assert not torch.equal(later, rounded)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [128, 50])
def test_cuda_round_only_matches_plain_version(cuda, dim):
    g = torch.Generator(device=cuda).manual_seed(dim)
    rows = torch.randn((N, dim), generator=g, device=cuda)
    idx = torch.randperm(R, generator=g, device=cuda)[:N].int()
    n_valid = torch.tensor([600], dtype=torch.int32, device=cuda)
    step = torch.tensor([2.0], device=cuda)
    before = row_ops.round_split_rows.launches
    got = row_ops.round_split_rows(rows, idx, step, n_valid, SEED)
    want = row_ops.round_split_rows_reference(rows, idx, step, n_valid, SEED)
    assert row_ops.round_split_rows.launches == before + 1
    assert _live_bits_equal(got, want, 600)


@pytest.mark.cuda
def test_cuda_split_kernel_takes_misaligned_rows(cuda):
    """Rows one float into their storage miss the 16-byte vector loads:
    the kernel takes its scalar loads, with the same bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    rows = torch.randn(N * DIM + 1, generator=g, device=cuda)[1:].view(N, DIM)
    idx = torch.randperm(R, generator=g, device=cuda)[:N].int()
    n_valid = torch.tensor([N], dtype=torch.int32, device=cuda)
    step = torch.tensor([1.0], device=cuda)
    got = row_ops.round_split_rows(rows, idx, step, n_valid, SEED)
    want = row_ops.round_split_rows(rows.contiguous().clone(), idx, step,
                                    n_valid, SEED)
    assert _live_bits_equal(got, want, N)


@pytest.mark.cuda
def test_cuda_split_kernel_refuses_rows_wider_than_it_holds(cuda):
    rows = torch.zeros((4, row_ops.MAX_SPLIT_DIM + 4), device=cuda)
    before = row_ops.round_split_rows.launches
    with pytest.raises(ValueError, match="at most"):
        row_ops.round_split_rows(
            rows, torch.arange(4, dtype=torch.int32, device=cuda),
            torch.zeros(1, device=cuda),
            torch.tensor([4], dtype=torch.int32, device=cuda), SEED)
    assert row_ops.round_split_rows.launches == before
