"""The build of a packed stack's state on the card holds the state and
one initialization chunk: no [R, dim] table or slot beside it. Skips
without a CUDA device; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_stack_build_cuda.py

Bound: the build's `max_memory_allocated` over what was allocated
before it is at most the state's bytes, one chunk of f32 draws
([chunk_rows, dim]) and the initializer's own peak on one draw block
(measured here), with 1 MiB for the allocator's rounding. The tables
are sized so that a [R, dim] f32 temporary would pass the bound.
"""

import pytest
import torch

from keras_rs_tpu_torch.core import initializers as init_lib
from keras_rs_tpu_torch.layers.embedding import config, stacking
from keras_rs_tpu_torch.layers.embedding.distributed_embedding import (
    DistributedEmbedding,
)
from keras_rs_tpu_torch.layers.embedding.lookup import build_stack_state

DIM = 128
ROUNDING = 1 << 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _features(vocab, optimizer):
    t = config.TableConfig(
        name="t", vocabulary_size=vocab, embedding_dim=DIM,
        optimizer=optimizer, combiner="sum", placement="sharded",
        max_ids_per_partition=256, max_unique_ids_per_partition=256,
    )
    return [config.FeatureConfig(name="f", table=t, input_shape=(64, 1),
                                 output_shape=(64, DIM))]


def _init_peak(fcs, device) -> int:
    """The table initializer's peak on one draw block."""
    t = fcs[0].table
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    block = init_lib.get(t.initializer)(
        (stacking.INIT_DRAW_ROWS, DIM), torch.float32, device,
        torch.Generator(device=device).manual_seed(0),
        fan_shape=(t.vocabulary_size, DIM))
    del block
    return torch.cuda.max_memory_allocated(device) - before


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer, vocab, chunk_rows, through_layer", [
    # The function with a chunk of one draw block: 2M rows.
    ("adagrad", 8 * stacking.INIT_DRAW_ROWS, stacking.INIT_DRAW_ROWS, False),
    ("adam", 8 * stacking.INIT_DRAW_ROWS, stacking.INIT_DRAW_ROWS, False),
    # DistributedEmbedding at the default chunk: 6M rows.
    ("adagrad", 6_000_000, stacking.INIT_CHUNK_ROWS, True),
])
def test_packed_build_holds_the_state_and_one_init_chunk(
        cuda, optimizer, vocab, chunk_rows, through_layer):
    fcs = _features(vocab, optimizer)
    init_peak = _init_peak(fcs, cuda)
    torch.cuda.empty_cache()
    torch.cuda.synchronize(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    generator = torch.Generator(device=cuda).manual_seed(1)
    if through_layer:
        layer = DistributedEmbedding(fcs, generator=generator, device=cuda)
        (stack,) = layer.stacks
        state = layer.stack_state(0)
    else:
        (stack,) = stacking.build_stacks(fcs, 1)
        state = build_stack_state(stack, {"t": fcs[0].table}, generator,
                                  cuda, chunk_rows=chunk_rows)
    torch.cuda.synchronize(cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - before
    assert stack.packed_state
    table = state["table"]
    state_bytes = table.numel() * table.element_size()
    chunk_bytes = min(chunk_rows, vocab) * DIM * 4
    table_bytes = stack.rows_per_shard * DIM * 4
    assert peak <= state_bytes + chunk_bytes + init_peak + ROUNDING, (
        peak, state_bytes, chunk_bytes, init_peak)
    # The bound leaves no room for the table drawn whole beside the state.
    assert chunk_bytes + init_peak + ROUNDING < table_bytes
    assert table[:, 1].eq(0.1 if optimizer == "adagrad" else 0.0).all()
