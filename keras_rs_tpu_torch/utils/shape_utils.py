"""Shape checks and arithmetic (counterpart of
keras_rs_tpu/utils/shape_utils.py)."""

from __future__ import annotations

from typing import Sequence


def check_shapes_compatible(
    shape_a: Sequence[int | None], shape_b: Sequence[int | None]
) -> bool:
    """True when equal-rank shapes match, treating None as a wildcard."""
    if len(shape_a) != len(shape_b):
        return False
    return all(
        a is None or b is None or a == b
        for a, b in zip(shape_a, shape_b)
    )


def check_rank(
    rank: int,
    allowed_ranks: tuple[int, ...],
    tensor_name: str = "tensor",
) -> None:
    """Raises ValueError unless `rank` is one of `allowed_ranks`."""
    if rank not in allowed_ranks:
        raise ValueError(
            f"`{tensor_name}` must have rank in {allowed_ranks}, got "
            f"rank {rank}."
        )


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= x (tile/padding arithmetic)."""
    return ((x + multiple - 1) // multiple) * multiple
