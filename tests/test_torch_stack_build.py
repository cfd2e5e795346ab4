"""The in-place build of a stack's state (lookup.build_stack_state)
against the build it replaces: the stacked table drawn whole, then the
packed state allocated, the table copied into it and each slot made
whole and copied in. Bit for bit, for packed Adagrad, Adam and FTRL
stacks and for split stacks, at D = 1 and on every shard of D = 4, the
tables drawn over several draw blocks and init chunks.
"""

import pytest
import torch

from keras_rs_tpu_torch.layers.embedding import config, stacking
from keras_rs_tpu_torch.layers.embedding.lookup import build_stack_state

#: Draw blocks and chunks small enough that two tables of a few hundred
#: rows cross several of each.
DRAW_ROWS, CHUNK_ROWS = 64, 128


def _stack(dtype, optimizer, dim, D):
    tables = [
        config.TableConfig(
            name=f"t{i}", vocabulary_size=vocab, embedding_dim=dim,
            optimizer=optimizer, combiner="sum", placement="sharded",
            dtype=dtype, max_ids_per_partition=64,
            max_unique_ids_per_partition=64,
        )
        for i, vocab in enumerate((301, 517))
    ]
    fcs = [config.FeatureConfig(name=f"f{i}", table=t, input_shape=(8, 2),
                                output_shape=(8, dim))
           for i, t in enumerate(tables)]
    (stack,) = stacking.build_stacks(fcs, D)
    assert len(stack.tables) == 2
    return stack, {t.name: t for t in tables}


def _materialised(stack, cfgs, seed, shard):
    """The state as the build before the in-place one made it."""
    table = stacking.init_stack_table(
        stack, cfgs, torch.Generator().manual_seed(seed), "cpu",
        chunk_rows=CHUNK_ROWS, shard=shard)
    opt = stack.optimizer
    if not stack.packed_state:
        slots = {n: opt.init_slot(
            n, (table.shape[0],) if n in opt.rowwise_slots else table.shape)
            for n in opt.slot_names}
        return {"table": table.to(stack.storage_dtype), "slots": slots}
    packed = torch.empty((table.shape[0], stack.state_stride,
                          table.shape[1]), dtype=table.dtype)
    packed[:, 0] = table
    for i, name in enumerate(opt.slot_names):
        packed[:, 1 + i] = opt.init_slot(name, table.shape, table.dtype)
    return {"table": packed}


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize(
    "dtype, optimizer, dim, packed",
    [
        ("float32", "adagrad", 128, True),
        ("float32", "adam", 128, True),
        ("float32", "ftrl", 128, True),
        ("bfloat16", "rowwise_adagrad", 128, False),
        ("bfloat16", "adagrad", 32, False),
        ("float32", "sgd", 32, False),
    ],
)
def test_in_place_build_is_the_materialised_build(monkeypatch, dtype,
                                                  optimizer, dim, packed,
                                                  D):
    monkeypatch.setattr(stacking, "INIT_DRAW_ROWS", DRAW_ROWS)
    stack, cfgs = _stack(dtype, optimizer, dim, D)
    assert stack.packed_state == packed
    for shard in (range(D) if D > 1 else [None]):
        want = _materialised(stack, cfgs, 11, shard)
        got = build_stack_state(stack, cfgs, torch.Generator().manual_seed(11),
                                "cpu", shard=shard, chunk_rows=CHUNK_ROWS)
        assert set(got) == set(want) | {"step"}
        assert float(got["step"]) == 0.0
        assert got["table"].dtype == want["table"].dtype
        assert torch.equal(got["table"].view(torch.uint8),
                           want["table"].view(torch.uint8)), shard
        for name, slot in want.get("slots", {}).items():
            assert torch.equal(got["slots"][name], slot), (shard, name)
        if packed:  # real rows were drawn
            assert got["table"][: 301 // D, 0, :dim].ne(0).all()
