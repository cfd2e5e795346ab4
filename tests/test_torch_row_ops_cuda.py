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
