"""The GRU, prefetching and checkpoints on the card. Skips without a
CUDA device; imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trainer_cuda.py

Bounds: the GRU's state card against CPU within 1e-6 absolute for any
mask (holes included), and a run without the padded steps within 1e-6
of it (the CPU tests hold the carry bit for bit); prefetched
batches equal to their host arrays; a restored state equal bit for bit,
with the restore adding no device copy of the state (peak memory within
1 MB of the state already held).
"""

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.layers.recurrent import GRU
from keras_rs_tpu_torch.models.gru4rec import GRU4Rec, gru4rec_loss
from keras_rs_tpu_torch.training import checkpoint, train_state
from keras_rs_tpu_torch.training.trainer import Trainer, prefetch_to_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "left_padded", "holes"])
def test_gru_card_matches_cpu(cuda, mask):
    grus = {d: GRU(16, 32, device=d,
                   generator=torch.Generator(d).manual_seed(0))
            for d in ("cpu", cuda)}
    grus[cuda].load_state_dict(grus["cpu"].state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(128, 9, 16, generator=g)
    m = {"none": None,
         "left_padded": (torch.arange(9)[None, :]
                         >= torch.randint(0, 9, (128, 1), generator=g)),
         "holes": torch.rand(128, 9, generator=g) > 0.5}[mask]
    m = None if m is None else m.float()
    with torch.no_grad():
        h_cpu = grus["cpu"](x, m)
        h = grus[cuda](x.to(cuda), None if m is None else m.to(cuda))
    assert (h.cpu() - h_cpu).abs().max().item() <= 1e-6
    if mask == "holes":
        # Dropping the padded steps gives the same state (another batch
        # shape takes other cuBLAS kernels: 1e-6, not bit for bit).
        row = m[0].bool()
        with torch.no_grad():
            dense = grus[cuda](x[:1, row].to(cuda))
        assert (h[:1] - dense).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_prefetch_to_device_yields_equal_batches(cuda):
    rng = np.random.default_rng(0)
    batches = [{"ids": rng.integers(0, 100, (64, 5)),
                "w": (rng.random(64).astype(np.float32), [np.arange(3)])}
               for _ in range(6)]
    got = list(prefetch_to_device(iter(batches), size=2, device=cuda))
    assert len(got) == 6
    for g, b in zip(got, batches):
        assert g["ids"].device == cuda
        assert np.array_equal(g["ids"].cpu().numpy(), b["ids"])
        assert np.array_equal(g["w"][0].cpu().numpy(), b["w"][0])
        assert np.array_equal(g["w"][1][0].cpu().numpy(), b["w"][1][0])


@pytest.mark.cuda
def test_restore_copies_into_the_cards_buffers(cuda, tmp_path):
    """A DistributedEmbedding of ~0.5 GB of state (table + Adam slots):
    restore writes into the registered buffers themselves (same storage)
    and adds no second copy on the card."""
    table = TableConfig("t", 400_000, 128, optimizer="adam",
                        placement="sharded", max_ids_per_partition=512,
                        max_unique_ids_per_partition=512)
    fc = FeatureConfig("f", table, (64, 4), (64, 128))

    def layer(seed):
        return DistributedEmbedding(
            {"f": fc}, device=cuda,
            generator=torch.Generator(cuda).manual_seed(seed))

    src = layer(0)
    path = str(tmp_path / "de")
    checkpoint.save_checkpoint(path, src)
    dst = layer(1)
    ptrs = {k: v.data_ptr() for k, v in dst.state_dict().items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    checkpoint.restore_checkpoint(path, dst)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 1 << 20
    for k, v in dst.state_dict().items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v, src.state_dict()[k]), k


@pytest.mark.cuda
def test_gru4rec_fit_resume_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(0)

    def batch():
        return {"item_history": rng.integers(0, 301, (256, 10)),
                "target_item": rng.integers(1, 301, 256)}

    batches = [batch() for _ in range(7)]

    def trainer(seed):
        m = GRU4Rec(300, 64, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(seed))
        return Trainer(m, train_state.DenseAdam(m.parameters(), 0.01),
                       gru4rec_loss)

    a = trainer(0)
    a.fit(batches[:4], prefetch=2, log_every=0,
          checkpoint_dir=str(tmp_path))
    in_memory = [float(a.step(b)) for b in batches[4:]]
    b = trainer(1)
    checkpoint.restore_checkpoint(str(tmp_path / "last"), b.state)
    resumed = [float(b.step(x)) for x in batches[4:]]
    np.testing.assert_allclose(resumed, in_memory, rtol=1e-6)
