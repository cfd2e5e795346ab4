"""Shape arithmetic (counterpart of keras_rs_tpu/utils/shape_utils.py)."""

from __future__ import annotations


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= x (tile/padding arithmetic)."""
    return ((x + multiple - 1) // multiple) * multiple
