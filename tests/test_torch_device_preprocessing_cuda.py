"""The device COO transform on the card against the port's numpy path,
with `torch.cuda.set_sync_debug_mode("error")` on: the transform must not
wait for the device. Also the DLRM's device-preprocessing step against
its host path, and EmbedReduce's out-of-range rows on CUDA. Skips without
a CUDA device; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_device_preprocessing_cuda.py

Bounds: integer arrays and stats bit-exact; gains and divisors bit-exact
for all-sum stacks, rtol 1e-6 for mean / sqrtn (index_add_'s float
atomics add in another order than numpy).
"""

import warnings

import numpy as np
import pytest
import torch

from keras_rs_tpu_torch.data import synthetic
from keras_rs_tpu_torch.layers.embedding import preprocessing
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.device_preprocessing import (
    preprocess_stack_device,
)
from keras_rs_tpu_torch.layers.embedding.embed_reduce import EmbedReduce
from keras_rs_tpu_torch.layers.embedding.stacking import build_stacks
from keras_rs_tpu_torch.models.dlrm import DLRMConfig, DLRMDCNv2

INT_KEYS = ("send_slots", "send_segs", "unique_slots", "entry_unique",
            "fwd_slots")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode(0)


# (D, batch, valences, combiners, vocabs, C, U)
CASES = {
    "one_shard_all_sum": (1, 512, (3, 1, 7), ("sum",) * 3,
                          (5000, 300, 100_000), 512 * 11, 512 * 11),
    "one_shard_drops": (1, 256, (3, 2), ("sum", "sum"), (2000, 50), 600,
                        300),
    "four_shards_mixed": (4, 128, (4, 2), ("mean", "sqrtn"), (997, 61),
                          400, 200),
    "four_shards_drops": (4, 64, (5, 3), ("sum", "mean"), (300, 40), 12, 8),
}


def _stack_and_inputs(case, seed=0):
    D, batch, valences, combiners, vocabs, C, U = CASES[case]
    tables = [TableConfig(f"t{i}", v, 16, optimizer="sgd", combiner=c,
                          max_ids_per_partition=C,
                          max_unique_ids_per_partition=U)
              for i, (v, c) in enumerate(zip(vocabs, combiners))]
    fcs = [FeatureConfig(f"f{i}", t, (batch, L), (batch, 16))
           for i, (t, L) in enumerate(zip(tables, valences))]
    (stack,) = build_stacks(fcs, D)
    rng = np.random.default_rng(seed)
    inputs, weights = {}, {}
    for f, v, L in zip(fcs, vocabs, valences):
        inputs[f.name] = rng.integers(-2, v + 2, size=(batch, L))
        w = rng.uniform(0.5, 2.0, size=(batch, L)).astype(np.float32)
        w[rng.random(w.shape) < 0.1] = 0.0
        weights[f.name] = w
    if all(c == "sum" for c in combiners):
        weights = None
    return stack, inputs, weights


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_transform_matches_numpy_without_syncs(cuda, case):
    stack, inputs, weights = _stack_and_inputs(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host, hstats = preprocessing.preprocess_stack(
            stack, inputs, weights, backend="numpy")
    t_in = {k: torch.from_numpy(v).to(cuda) for k, v in inputs.items()}
    t_w = (None if weights is None else
           {k: torch.from_numpy(v).to(cuda) for k, v in weights.items()})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    coo, stats = preprocess_stack_device(stack, t_in, t_w)
    torch.cuda.set_sync_debug_mode(0)
    all_sum = weights is None
    got = coo.arrays()
    assert got.keys() == host.arrays().keys()
    for k, want in host.arrays().items():
        assert got[k].is_cuda
        v = got[k].cpu().numpy()
        assert v.dtype == want.dtype and v.shape == want.shape, k
        if k in INT_KEYS or all_sum:
            np.testing.assert_array_equal(v, want, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=1e-6, err_msg=k)
    assert preprocessing.InputStats(*(int(x) for x in stats)) == hstats


@pytest.mark.cuda
def test_dlrm_preprocess_on_device_matches_host_path(cuda):
    """The lookup arrays of preprocess_on_device equal preprocess's, and
    so do the logits from each."""
    B = 256
    cfg = DLRMConfig(
        vocab_sizes=[40_000, 30_000, 50, 30], multi_hot_sizes=[3, 2, 1, 2],
        bottom_mlp=(64, 128), top_mlp=(64, 32, 1), num_dcn_layers=1,
        dcn_projection_dim=32, max_ids_per_partition=B * 5,
        max_unique_ids_per_partition=B * 5, global_batch_size=B,
        table_placement="sharded",
    )
    model = DLRMDCNv2(cfg, generator=torch.Generator(cuda).manual_seed(0),
                      device=cuda)
    raw = synthetic.criteo_like_batch(B, vocab_sizes=cfg.vocab_sizes,
                                      multi_hot_sizes=cfg.multi_hot_sizes,
                                      seed=3)
    host = model.preprocess(raw)
    on_card = model.to_device(raw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    dev = model.preprocess_on_device(on_card)
    torch.cuda.set_sync_debug_mode(0)
    (name,) = host["large_pre"]["sharded"]
    for k, want in host["large_pre"]["sharded"][name].items():
        got = dev["large_pre"]["sharded"][name][k]
        assert got.dtype == want.dtype, k
        assert torch.equal(got, want), k
    with torch.no_grad():
        assert torch.equal(model(dev), model(host))


@pytest.mark.cuda
def test_embed_reduce_out_of_range_ids_give_nan_rows(cuda):
    """No device-side assert: ids >= vocab give NaN rows, -1 the last
    row, and the context stays usable."""
    g = torch.Generator(cuda).manual_seed(0)
    layer = EmbedReduce(20, 8, generator=g, combiner="sum", device=cuda)
    ids = torch.tensor([[0, 20], [-1, 5], [10**6, -21]], device=cuda)
    out = layer(ids[:, :1])
    table = layer.embeddings.detach()
    torch.testing.assert_close(out[1], table[19])
    assert bool(torch.isnan(out[2]).all())
    assert bool(torch.isnan(layer(ids)[0]).all())
    assert bool(torch.isfinite(layer(ids[1:2])).all())
    torch.cuda.synchronize()
