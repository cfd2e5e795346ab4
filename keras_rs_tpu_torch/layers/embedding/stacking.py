"""Table stacking and MOD-sharded layout (jax-free).

Counterpart of keras_rs_tpu/layers/embedding/stacking.py, with the same
layout so that preprocessing output and exported tables agree bit for
bit with the JAX package:

  * each table's vocabulary is padded up to a multiple of D (shards);
  * global row r of table t lives on shard `(r + rot_t) % D` at local
    slot `offset_t + r // D`, rot_t = the table's index in its stack
    (mod D), or 0 for every table with `shard_rotation=False`;
  * per-shard blocks of all tables in the stack are concatenated, plus
    one trailing sink row (`rows_per_shard - 1`) that absorbs padding
    traffic;
  * stack_dim = max table dim rounded up to a multiple of 8.

At D > 1 each rank holds one shard, the [rows_per_shard, ...] block of
the stacked global array that the JAX package places on device r:
`init_stack_table(..., shard=r)` materializes it, `scatter_table(...,
shard=r)`, `shard_block` and `unshard_table` move one table's logical
rows in and out of it. Within shard r, table t's rows sit at local slots
offset_t + k, k = 0, 1, ..., for the logical rows k * D + (r - rot_t) %
D. The bit-packed bf16 layout of the JAX package is not ported (it
exists for a TPU DMA limit): a bf16 stack stores plain
[R, dim] bf16 rows and keeps `rows_per_shard = offset + 1`, where the
JAX package's bit-packed stacks (bf16, dim 128) round it to
`round_up(offset, 2) + 2`. Logical tables agree either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import torch

from keras_rs_tpu_torch.core import initializers as init_lib
from keras_rs_tpu_torch.layers.embedding import optimizers as opt_lib
from keras_rs_tpu_torch.layers.embedding.config import (
    FeatureConfig,
    TableConfig,
)
from keras_rs_tpu_torch.utils.shape_utils import round_up as _round_up

_STORAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: Rows drawn from one generator when a table is initialized: every block
#: of this many rows has its own seed, so the values do not depend on how
#: many rows are drawn at once (`init_stack_table`'s chunk_rows).
INIT_DRAW_ROWS = 1 << 18
#: Default rows per initialization chunk (2 GB of f32 at dim 128).
INIT_CHUNK_ROWS = 1 << 22


@dataclasses.dataclass(frozen=True)
class StackedTableSpec:
    """Static layout of one table inside a stack."""

    name: str
    vocabulary_size: int
    embedding_dim: int
    padded_vocab: int  # multiple of num_shards
    local_offset: int  # first local slot of this table on every shard
    combiner: str
    rotation: int = 0  # shard rotation: row r lives on (r + rotation) % D


@dataclasses.dataclass(frozen=True)
class StackedFeatureSpec:
    """Static binding of one feature to its stack."""

    name: str
    table_name: str
    stack_name: str
    feature_index: int  # block index within the stack's sample space
    batch_size: int  # global batch
    valence: int
    embedding_dim: int


@dataclasses.dataclass(frozen=True)
class TableStack:
    """One fused, sharded table group."""

    name: str
    num_shards: int
    stack_dim: int
    rows_per_shard: int  # includes the trailing sink row
    tables: tuple[StackedTableSpec, ...]
    features: tuple[StackedFeatureSpec, ...]
    optimizer: opt_lib.EmbeddingOptimizer
    max_ids_per_partition: int  # capacity C of each (src, dst) bucket
    max_unique_ids_per_shard: int  # capacity U of per-shard unique list
    dtype: str = "float32"
    #: Packed state layout: the table row and its optimizer-slot rows
    #: form the [state_stride, dim] block of one 3-D
    #: [global_rows, state_stride, dim] array, so one unique row's
    #: table + slots are one contiguous byte range and the backward's
    #: update is one read-modify-write per row (ops/row_ops.py).
    packed_state: bool = False

    @property
    def storage_dtype(self) -> torch.dtype:
        """The table's storage type (optimizer slots are always f32)."""
        return _STORAGE_DTYPES[self.dtype]

    @property
    def state_stride(self) -> int:
        """Rows per logical row in the state array (1 + #slots if packed)."""
        return (
            1 + len(self.optimizer.slot_names) if self.packed_state else 1
        )

    @property
    def sink_slot(self) -> int:
        return self.rows_per_shard - 1

    @property
    def construction_entries(self) -> int:
        """Total id slots in construction order (features concatenated,
        each sample-major (B, valence), invalid ids included)."""
        return sum(f.batch_size * f.valence for f in self.features)

    @property
    def construction_fwd(self) -> bool:
        """Whether the D == 1 construction-order forward applies: one
        shard, and every entry fits the bucket (N <= C), so the combiner
        reduce is a dense per-feature reshape-sum with no drops."""
        return (
            self.num_shards == 1
            and self.construction_entries <= self.max_ids_per_partition
        )

    @property
    def global_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def local_batch_size(self) -> int:
        """Samples of one shard's slice of the batch (B / D)."""
        return self.batch_size // self.num_shards

    @property
    def num_features(self) -> int:
        return len(self.features)

    @property
    def batch_size(self) -> int:
        return self.features[0].batch_size

    def table_spec(self, name: str) -> StackedTableSpec:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(name)


def _optimizer_key(table: TableConfig) -> str:
    opt = opt_lib.get(table.optimizer)
    if callable(opt.learning_rate):
        # A schedule is keyed by identity, the rest of the config by
        # value: two tables stack only when they share the same schedule
        # object and every other hyperparameter.
        cfg = {k: v for k, v in vars(opt).items()
               if k != "learning_rate" and not callable(v)}
        return f"{opt.name}:{id(opt.learning_rate)}:{sorted(cfg.items())}"
    return f"{opt.name}:{sorted(opt.get_config().items())}"


def build_stacks(
    feature_configs: Sequence[FeatureConfig],
    num_shards: int,
    *,
    stacking: str | Sequence[Sequence[str]] = "auto",
    shard_rotation: bool = True,
) -> list[TableStack]:
    """Groups tables into stacks and computes the sharded layout, as the
    JAX package's build_stacks does.

    `stacking`:
      * "auto": tables with the same optimizer, padded dim and dtype
        share a stack;
      * "never": one stack per table;
      * explicit: a list of lists of table names, one stack each (a
        table not listed gets its own stack); every table of a group
        must share the optimizer and the dtype.

    `shard_rotation`: table t's rows are rotated by its index in the
    stack (mod D), so the head rows of stacked vocabularies spread over
    the shards; False is plain MOD sharding (rotation 0). The layouts
    differ, so a state of one does not load into the other.
    """
    tables: list[TableConfig] = []
    table_features: dict[int, list[FeatureConfig]] = {}
    for fc in feature_configs:
        tid = id(fc.table)
        if tid not in table_features:
            tables.append(fc.table)
            table_features[tid] = []
        table_features[tid].append(fc)

    names = [t.name for t in tables]
    if len(set(names)) != len(names):
        raise ValueError(f"Duplicate table names: {names}")

    groups: list[list[TableConfig]]
    if stacking == "never":
        groups = [[t] for t in tables]
    elif stacking == "auto":
        by_key: dict[str, list[TableConfig]] = {}
        for t in tables:
            key = (
                f"{_optimizer_key(t)}|dim{_round_up(t.embedding_dim, 8)}"
                f"|{t.dtype}"
            )
            by_key.setdefault(key, []).append(t)
        groups = list(by_key.values())
    elif isinstance(stacking, str):
        raise ValueError(
            f"Unknown stacking {stacking!r}: use 'auto', 'never' or a list "
            "of lists of table names."
        )
    else:
        explicit = {name: i for i, g in enumerate(stacking) for name in g}
        grouped: dict[int | str, list[TableConfig]] = {}
        for t in tables:
            grouped.setdefault(explicit.get(t.name, f"solo_{t.name}"),
                               []).append(t)
        groups = list(grouped.values())

    stacks = []
    for group in groups:
        if len({_optimizer_key(t) for t in group}) != 1:
            raise ValueError(
                "All tables in a stack must share the same optimizer; got "
                f"{[t.name for t in group]}."
            )
        if len({t.dtype for t in group}) != 1:
            raise ValueError(
                "All tables in a stack must share the same dtype; got "
                f"{[t.name for t in group]}."
            )
        stack_dim = max(_round_up(t.embedding_dim, 8) for t in group)
        specs: list[StackedTableSpec] = []
        offset = 0
        for ti, t in enumerate(group):
            padded = _round_up(t.vocabulary_size, num_shards)
            specs.append(
                StackedTableSpec(
                    name=t.name,
                    vocabulary_size=t.vocabulary_size,
                    embedding_dim=t.embedding_dim,
                    padded_vocab=padded,
                    local_offset=offset,
                    combiner=t.combiner,
                    rotation=(ti % num_shards) if shard_rotation else 0,
                )
            )
            offset += padded // num_shards

        stack_name = "_".join(t.name for t in group)
        if len(stack_name) > 64:
            digest = hashlib.sha1(stack_name.encode()).hexdigest()[:8]
            stack_name = f"{stack_name[:55]}_{digest}"
        feature_specs: list[StackedFeatureSpec] = []
        batch_sizes = set()
        for t in group:
            for fc in table_features[id(t)]:
                batch_sizes.add(fc.batch_size)
                feature_specs.append(
                    StackedFeatureSpec(
                        name=fc.name,
                        table_name=t.name,
                        stack_name=stack_name,
                        feature_index=len(feature_specs),
                        batch_size=fc.batch_size,
                        valence=fc.valence,
                        embedding_dim=t.embedding_dim,
                    )
                )
        if len(batch_sizes) != 1:
            raise ValueError(
                "All features of stacked tables must share the same global "
                f"batch size; got {sorted(batch_sizes)} in stack "
                f"{stack_name}."
            )
        if batch_sizes.pop() % num_shards != 0:
            raise ValueError(
                "Global batch size must be divisible by the number of "
                f"shards ({num_shards})."
            )

        optimizer = opt_lib.get(group[0].optimizer)
        n_slots = len(optimizer.slot_names)
        # The packed rule of the JAX package (stacking.py:313-319), kept
        # so both packages agree on which stacks are packed.
        packed = (
            group[0].dtype == "float32"
            and n_slots >= 1
            and not optimizer.rowwise_slots  # [R] slots are not rows
            and stack_dim % 128 == 0
            and (1 + n_slots) * stack_dim <= 512
        )
        stacks.append(
            TableStack(
                name=stack_name,
                num_shards=num_shards,
                stack_dim=stack_dim,
                rows_per_shard=offset + 1,  # + sink row
                tables=tuple(specs),
                features=tuple(feature_specs),
                optimizer=optimizer,
                max_ids_per_partition=max(
                    t.max_ids_per_partition for t in group
                ),
                max_unique_ids_per_shard=(
                    max(t.max_unique_ids_per_partition for t in group)
                    * num_shards
                ),
                dtype=group[0].dtype,
                packed_state=packed,
            )
        )
    return stacks


def _global_rows_of(stack: TableStack, t: StackedTableSpec, device,
                    lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Stacked global row of each logical row r in [lo, hi) (default: the
    whole vocabulary)."""
    D = stack.num_shards
    r = torch.arange(
        lo, t.vocabulary_size if hi is None else hi, device=device
    )
    return (
        (r + t.rotation) % D
    ) * stack.rows_per_shard + t.local_offset + r // D


def _shard_run(stack: TableStack, t: StackedTableSpec, shard: int,
               lo: int, hi: int) -> tuple[int, int, int]:
    """The logical rows of [lo, hi) that live on `shard`: every D-th row
    from lo + first, at `count` consecutive local slots from `slot`.
    Returns (first, slot, count)."""
    D = stack.num_shards
    first = (shard - t.rotation - lo) % D
    count = max(0, -(-(hi - lo - first) // D))
    return first, t.local_offset + (lo + first) // D, count


def init_stack_table(
    stack: TableStack,
    table_configs: dict[str, TableConfig],
    generator: torch.Generator | None = None,
    device=None,
    chunk_rows: int = INIT_CHUNK_ROWS,
    shard: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Materializes the stacked global array [D * rows_per_shard, dim]
    in the stack's storage dtype, or with `shard` that shard's block
    [rows_per_shard, dim]. With `out`, a tensor of that shape and dtype
    (a view, such as the table rows of a packed state), it writes the
    array there in place and returns `out`: nothing of the array's size
    is allocated beside it.

    Each table draws from its own initializer, scaled by its true
    [vocabulary_size, embedding_dim] shape (so fan-based initializers see
    the table's dim), in f32 chunks of at most `chunk_rows` rows, each
    rounded to the storage dtype and written straight into its
    MOD-interleaved rows; every other row (dim padding, vocab padding,
    the sink) is zero. A table takes one seed from `generator` and draws
    each INIT_DRAW_ROWS-row block from its own generator seeded from it,
    so the same rows come out for a given generator whatever chunk_rows
    is, and every rank of a D-shard layer draws the whole logical table
    from the same generator and keeps its rows: the logical tables do
    not depend on D. `generator` must live on `device`.
    """
    if out is None:
        out = torch.zeros(
            (stack.global_rows if shard is None else stack.rows_per_shard,
             stack.stack_dim), dtype=stack.storage_dtype, device=device,
        )
    else:
        out.zero_()
    gen_device = out.device if generator is None else generator.device
    chunk = max(1, chunk_rows // INIT_DRAW_ROWS) * INIT_DRAW_ROWS
    for t in stack.tables:
        initializer = init_lib.get(table_configs[t.name].initializer)
        fan_shape = (t.vocabulary_size, t.embedding_dim)
        seed = int(torch.randint(
            0, 1 << 62, (1,), generator=generator, device=gen_device
        ))
        for lo in range(0, t.vocabulary_size, chunk):
            hi = min(lo + chunk, t.vocabulary_size)
            values = torch.empty(
                (hi - lo, t.embedding_dim), dtype=torch.float32,
                device=out.device,
            )
            for b in range(lo, hi, INIT_DRAW_ROWS):
                n = min(INIT_DRAW_ROWS, hi - b)
                block = torch.Generator(device=out.device).manual_seed(
                    seed + b // INIT_DRAW_ROWS
                )
                values[b - lo : b - lo + n] = initializer(
                    (n, t.embedding_dim), torch.float32, out.device,
                    block, fan_shape=fan_shape,
                )
            if shard is None:
                out[_global_rows_of(stack, t, out.device, lo, hi),
                    : t.embedding_dim] = values.to(out.dtype)
            else:
                first, slot, n = _shard_run(stack, t, shard, lo, hi)
                out[slot : slot + n, : t.embedding_dim] = values[
                    first :: stack.num_shards].to(out.dtype)
            del values
    return out


def table_rows(
    stack: TableStack, state_table: torch.Tensor, table_name: str,
    lo: int = 0, hi: int | None = None,
) -> torch.Tensor:
    """Rows [lo, hi) of one table (default: all), a [hi - lo, dim] copy
    in the storage dtype.

    `state_table` is the stacked global array, [global_rows, dim] (split)
    or the packed 3-D [global_rows, state_stride, dim] state, whose table
    rows are the leading row of each block.
    """
    t = stack.table_spec(table_name)
    arr = state_table[:, 0] if state_table.ndim == 3 else state_table
    idx = _global_rows_of(stack, t, state_table.device, lo, hi)
    return arr[idx, : t.embedding_dim]


def gather_table(
    stack: TableStack, state_table: torch.Tensor, table_name: str
) -> torch.Tensor:
    """Unstacks one table of the global array back to [vocab, dim] (a
    copy)."""
    return table_rows(stack, state_table, table_name)


def shard_block(stack: TableStack, state_table: torch.Tensor,
                table_name: str) -> torch.Tensor:
    """One shard's block of a table: its [padded_vocab / D, dim] local
    slots (padding rows included), a view of the table plane."""
    t = stack.table_spec(table_name)
    arr = state_table[:, 0] if state_table.ndim == 3 else state_table
    n = t.padded_vocab // stack.num_shards
    return arr[t.local_offset : t.local_offset + n, : t.embedding_dim]


def unshard_table(stack: TableStack, table_name: str, blocks: torch.Tensor,
                  lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Logical rows [lo, hi) (default: the whole vocabulary) of a table
    from every shard's `shard_block` rows lo // D onwards, stacked
    [D, n, dim] in shard order: logical row k * D + j lives on shard
    (j + rotation) % D at local row k."""
    t = stack.table_spec(table_name)
    D = stack.num_shards
    hi = t.vocabulary_size if hi is None else hi
    order = [(j + t.rotation) % D for j in range(D)]
    rows = blocks[order].transpose(0, 1).reshape(-1, blocks.shape[-1])
    first = lo - (lo // D) * D
    return rows[first : first + hi - lo]


def shard_table(stack: TableStack, table_name: str, values: torch.Tensor,
                shard: int) -> torch.Tensor:
    """The logical rows of `values` [vocab, dim] that live on `shard`, in
    local-slot order (a strided view)."""
    t = stack.table_spec(table_name)
    first, _, _ = _shard_run(stack, t, shard, 0, t.vocabulary_size)
    return values[first :: stack.num_shards]


def scatter_table(
    stack: TableStack,
    state_table: torch.Tensor,
    table_name: str,
    values: torch.Tensor,
    shard: int | None = None,
) -> None:
    """Writes [vocab, dim] values for one table into the stacked global
    array, or with `shard` the rows that live there into that shard's
    block, in place (slot rows of a packed state are untouched)."""
    t = stack.table_spec(table_name)
    if tuple(values.shape) != (t.vocabulary_size, t.embedding_dim):
        raise ValueError(
            f"Expected shape {(t.vocabulary_size, t.embedding_dim)}, got "
            f"{tuple(values.shape)}."
        )
    if shard is None:
        idx = _global_rows_of(stack, t, state_table.device)
    else:
        _, slot, n = _shard_run(stack, t, shard, 0, t.vocabulary_size)
        idx = slice(slot, slot + n)
        values = shard_table(stack, table_name, values, shard)
    values = values.to(state_table.device, state_table.dtype)
    if state_table.ndim == 3:
        state_table[idx, 0, : t.embedding_dim] = values
    else:
        state_table[idx, : t.embedding_dim] = values
