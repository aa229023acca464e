"""Rounding to a lower precision, for the control: the reference computed
in the nearest precision below the program's float32."""

from __future__ import annotations

import numpy as np


def bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (nearest, ties to even), returned as float64."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32).astype(np.float64)
