"""Common type aliases (counterpart of keras_rs_tpu/types.py)."""

from __future__ import annotations

from typing import Sequence

Shape = Sequence[int]
