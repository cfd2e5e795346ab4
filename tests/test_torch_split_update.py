"""The split update of bf16 tables (keras_rs_tpu_torch/ops/row_ops.py:
apply_split_rows, round_split_rows) through their plain versions on the
CPU: row-wise Adagrad then stochastic rounding with Philox4x32-10 bits
drawn from the step, the shard and the row; and which path the lookup's
split update takes for each table type and optimizer.

Bounds: against `RowWiseAdagrad.apply` followed by the rounding with the
same bits, rows within one bf16 ulp and accumulators within f32 rtol 1e-6
(the plain version sums the squares in the kernel's order, four columns
per lane and then a tree over 32 lanes, and takes the square root in
f64; `apply` sums in torch's order). Everything else bit for bit.
"""

import math

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (caps torch's threads)
from torch_parity import assert_within_bf16_ulps

from keras_rs_tpu_torch.layers.embedding import lookup, optimizers
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.ops import quant, row_ops

R, N = 5000, 700
SEED = lookup.ROUNDING_SEED


def _case(dim: int, nv: int = 600, seed: int = 0):
    """A bf16 table with its accumulator, and an update's idx (sorted
    distinct rows, then the sink R - 1) and gradients (zero past nv)."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn((R, dim), generator=g).to(torch.bfloat16)
    acc = torch.rand(R, generator=g) + 0.1
    idx = torch.full((N,), R - 1, dtype=torch.int32)
    idx[:nv] = torch.randperm(R - 1, generator=g)[:nv].sort().values.int()
    grads = torch.randn((N, dim), generator=g) * 0.3
    grads[nv:] = 0.0
    return table, acc, idx, grads, torch.tensor([nv], dtype=torch.int32)


def _apply(table, acc, idx, grads, n_valid, step=3.0,
           opt=None, seed=SEED):
    opt = opt or optimizers.RowWiseAdagrad(learning_rate=0.05)
    return row_ops.apply_split_rows(table, acc, idx, grads,
                                    torch.tensor([step]), opt, n_valid, seed)


@pytest.mark.parametrize("dim", [128, 64, 50])
@pytest.mark.parametrize("step", [0.0, 7.0])
def test_apply_equals_rowwise_adagrad_then_rounding(dim, step):
    table, acc, idx, grads, n_valid = _case(dim)
    nv = int(n_valid)
    opt = optimizers.RowWiseAdagrad(learning_rate=0.05)
    live = idx[:nv].long()
    want_rows, want_slots = opt.apply(
        table[live].float(), grads[:nv], {"accumulator": acc[live]},
        torch.tensor(step))
    bits = row_ops.split_rounding_bits(idx[:nv], dim, torch.tensor([step]),
                                       SEED)
    want = quant.stochastic_round_bf16_bits(want_rows, bits & 0xFFFF)
    got_acc = acc.clone()
    got = _apply(table, got_acc, idx, grads, n_valid, step, opt)
    assert got.dtype == torch.bfloat16 and got.shape == (N, dim)
    assert_within_bf16_ulps(got[:nv].float().numpy(),
                            want.float().numpy(), ulps=1.0)
    np.testing.assert_allclose(got_acc[live].numpy(),
                               want_slots["accumulator"].numpy(),
                               rtol=1e-6)
    # The rounding moved some rows off their nearest bf16 value.
    assert not torch.equal(got[:nv], want_rows.to(torch.bfloat16))


@pytest.mark.parametrize("nv", [0, 333, N])
def test_tail_positions_and_the_sink_are_left_alone(nv):
    table, acc, idx, grads, n_valid = _case(128, nv=min(nv, N))
    if nv == N:
        idx = torch.randperm(R - 1, generator=torch.Generator().manual_seed(
            1))[:N].sort().values.int()
    before_table, before_acc = table.clone(), acc.clone()
    _apply(table, acc, idx, grads, n_valid)
    assert torch.equal(table.view(torch.int16),
                       before_table.view(torch.int16))
    untouched = torch.ones(R, dtype=torch.bool)
    untouched[idx[:nv].long()] = False
    assert bool(untouched[R - 1])  # the sink
    assert torch.equal(acc[untouched], before_acc[untouched])
    assert bool((acc[~untouched] > before_acc[~untouched]).all())


def test_a_schedule_is_read_from_the_step_tensor():
    def schedule(step):
        return 0.05 * 0.5 ** (step / 2.0)

    table, acc, idx, grads, n_valid = _case(128)
    for step in (0.0, 4.0):
        rate = float(schedule(torch.tensor(step)))
        got = _apply(table, acc.clone(), idx, grads, n_valid, step,
                     optimizers.RowWiseAdagrad(learning_rate=schedule))
        want = _apply(table, acc.clone(), idx, grads, n_valid, step,
                      optimizers.RowWiseAdagrad(learning_rate=rate))
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    fixed = _apply(table, acc.clone(), idx, grads, n_valid, 4.0,
                   optimizers.RowWiseAdagrad(learning_rate=0.05))
    assert not torch.equal(got, fixed)


#: Philox4x32-10 known answers (Random123's kat_vectors, Salmon et al.,
#: SC'11): counter words, key words, output words.
PHILOX_KAT = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
     (0x00000000, 0x00000000),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
     (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", PHILOX_KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    assert row_ops.philox4x32_10(counter, key) == want
    got = row_ops.philox4x32_10(
        tuple(torch.tensor([c, c], dtype=torch.int64) for c in counter),
        tuple(torch.tensor(k, dtype=torch.int64) for k in key))
    assert [w.tolist() for w in got] == [[x, x] for x in want]


def test_bits_follow_step_shard_and_row_not_position():
    idx = torch.tensor([5, 9, 4000, 17], dtype=torch.int32)

    def bits(step, seed=SEED, ix=idx):
        return row_ops.split_rounding_bits(ix, 128, torch.tensor([step]),
                                           seed)

    base = bits(3.0)
    assert base.shape == (4, 128) and bool((base >= 0).all())
    assert bool((base < 2**32).all())
    assert torch.equal(base, bits(3.0))
    assert not (bits(4.0) == base).any()
    assert not (bits(3.0, SEED + (1 << 24)) == base).any()
    # Rows differ from each other, and a row's bits go with it.
    assert len({tuple(r.tolist()) for r in base}) == 4
    perm = torch.tensor([2, 0, 3, 1])
    assert torch.equal(bits(3.0, ix=idx[perm]), base[perm])
    # Key words: the step adds to the low word, the seed base is the high.
    key = SEED + 3
    assert torch.equal(base[1, :4], torch.tensor(row_ops.philox4x32_10(
        (9, 0, 0, 0), (key & 0xFFFFFFFF, key >> 32))))
    assert torch.equal(base[1, 4:8], torch.tensor(row_ops.philox4x32_10(
        (9, 1, 0, 0), (key & 0xFFFFFFFF, key >> 32))))


def test_the_order_of_rows_changes_no_result():
    table, acc, idx, grads, n_valid = _case(128)
    nv = int(n_valid)
    perm = torch.cat([torch.randperm(nv, generator=torch.Generator()
                                     .manual_seed(2)), torch.arange(nv, N)])
    a_acc, b_acc = acc.clone(), acc.clone()
    a = _apply(table, a_acc, idx, grads, n_valid)
    b = _apply(table, b_acc, idx[perm].contiguous(),
               grads[perm].contiguous(), n_valid)
    assert torch.equal(a[perm][:nv].view(torch.int16),
                       b[:nv].view(torch.int16))
    assert torch.equal(a_acc, b_acc)


@pytest.mark.parametrize("x, up_share", [
    (1.0 + 2.0**-8, 0.5), (-(1.0 + 2.0**-8), 0.5), (1.0 + 2.0**-9, 0.25),
], ids=["midway", "midway-negative", "quarter"])
def test_rounding_is_unbiased(x, up_share):
    """20,000 roundings (ulp 2^-7 at 1.0): the mean lies within 3
    standard errors of x, and the share rounded away from zero is the
    distance's."""
    n = 20000
    rows = torch.full((n, 1), x)
    idx = torch.arange(n, dtype=torch.int32)
    out = row_ops.round_split_rows(rows, idx, torch.tensor([11.0]),
                                   torch.tensor([n], dtype=torch.int32),
                                   SEED).float()[:, 0]
    ulp = 2.0**-7
    lo = math.copysign(1.0, x)
    assert set(out.tolist()) == {lo, lo + math.copysign(ulp, x)}
    stderr = ulp * math.sqrt(up_share * (1 - up_share) / n)
    assert abs(float(out.double().mean()) - x) < 3 * stderr
    assert abs(float((out.abs() > 1.0).double().mean()) - up_share) < 0.02


def test_exact_values_pass_through():
    x = torch.tensor([1.0, -2.0, 0.0, 0.5, 3.0 * 2.0**-100, -0.0])
    rows = x[:, None].repeat(1, 8)
    out = row_ops.round_split_rows(rows, torch.arange(6, dtype=torch.int32),
                                   torch.tensor([2.0]),
                                   torch.tensor([6], dtype=torch.int32),
                                   SEED)
    assert torch.equal(out.float().view(torch.int32),
                       rows.view(torch.int32))


def test_round_repeats_and_is_the_bits_formula():
    x = torch.randn(64, 40, generator=torch.Generator().manual_seed(2))
    idx = torch.randperm(1000, generator=torch.Generator().manual_seed(3))[
        :64].int()
    args = (idx, torch.tensor([5.0]), torch.tensor([64], dtype=torch.int32),
            SEED)
    a = row_ops.round_split_rows(x, *args)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16),
                       row_ops.round_split_rows(x, *args).view(torch.int16))
    bits = row_ops.split_rounding_bits(idx, 40, torch.tensor([5.0]), SEED)
    assert torch.equal(
        a.view(torch.int16),
        quant.stochastic_round_bf16_bits(x, bits & 0xFFFF).view(torch.int16))
    # Every value is x truncated to bf16, or the next bf16 away from 0.
    trunc = (x.view(torch.int32) >> 16).int()
    diff = a.view(torch.int16).int() - trunc
    assert ((diff == 0) | (diff == 1)).all() and diff.any()


def test_wrappers_check_their_arguments():
    table, acc, idx, grads, n_valid = _case(128)
    with pytest.raises(ValueError, match="rowwise_adagrad"):
        _apply(table, acc, idx, grads, n_valid,
               opt=optimizers.Adagrad(learning_rate=0.05))
    with pytest.raises(ValueError, match="bfloat16"):
        _apply(table.float(), acc, idx, grads, n_valid)
    with pytest.raises(ValueError, match="acc"):
        _apply(table, acc[:-1], idx, grads, n_valid)
    with pytest.raises(ValueError, match="seed"):
        _apply(table, acc, idx, grads, n_valid, seed=-1)
    with pytest.raises(ValueError, match="idx"):
        row_ops.round_split_rows(grads, idx.long(), torch.tensor([0.0]),
                                 n_valid, SEED)
    with pytest.raises(ValueError, match="cpu or cuda"):
        row_ops.round_split_rows(grads.to("meta"), idx.to("meta"),
                                 torch.tensor([0.0], device="meta"),
                                 n_valid.to("meta"), SEED)


def _layer(dtype: str, optimizer: str) -> DistributedEmbedding:
    table = TableConfig(
        name="t", vocabulary_size=3000, embedding_dim=16,
        optimizer=optimizers.get(optimizer), placement="sharded",
        dtype=dtype, max_ids_per_partition=128,
        max_unique_ids_per_partition=128)
    features = {f"f{i}": FeatureConfig(name=f"f{i}", table=table,
                                       input_shape=(32, 2),
                                       output_shape=(32, 16))
                for i in range(2)}
    return DistributedEmbedding(features,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("dtype, optimizer, want", [
    ("bfloat16", "rowwise_adagrad", "apply"),
    ("bfloat16", "adagrad", "round"),
    ("bfloat16", "adam", "round"),
    ("bfloat16", "sgd", "round"),
    ("float32", "rowwise_adagrad", None),
])
def test_split_update_takes_the_kernel_of_its_stack(monkeypatch, dtype,
                                                    optimizer, want):
    calls = []
    for name in ("apply_split_rows", "round_split_rows"):
        def wrapped(*args, _name=name, _fn=getattr(lookup, name)):
            calls.append(_name.split("_")[0])
            return _fn(*args)

        monkeypatch.setattr(lookup, name, wrapped)
    layer = _layer(dtype, optimizer)
    ids = np.random.default_rng(0).integers(0, 3000, size=(32, 2))
    pre = layer.preprocess({"f0": ids, "f1": ids[::-1].copy()})
    before = [layer.stack_state(i)["table"].clone()
              for i in range(len(layer.stacks))]
    (stack,) = layer.stacks
    assert not stack.packed_state
    out = layer(pre)
    sum(v.sum() for v in out.values()).backward()
    assert calls == ([want] if want else [])
    state = layer.stack_state(0)
    assert not torch.equal(state["table"].float(), before[0].float())
    assert float(state["step"]) == 1.0
