"""Host helpers shared by the lane planners (numpy only).

Copies of ``qoipp_tpu.models.packed``'s rounding and unpacking helpers,
so the port's planners make the same plans as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _bucket_mult(n: int, m: int) -> int:
    """Round n up to a multiple of m on a coarse ladder: powers of two of
    m, with 5/8, 3/4 and 7/8 steps between them."""
    n = max(n, m)
    b = m
    while b < n:
        b *= 2
    for frac in (5 * b // 8, 3 * b // 4, 7 * b // 8):
        if frac >= n and frac % m == 0:
            return frac
    return b


def _unpack_pixels_np(packed: np.ndarray, channels: int) -> np.ndarray:
    """(N,) uint32 words -> (N * channels,) uint8 pixels."""
    out = np.empty((packed.size, channels), np.uint8)
    out[:, 0] = packed & 0xFF
    out[:, 1] = (packed >> 8) & 0xFF
    out[:, 2] = (packed >> 16) & 0xFF
    if channels == 4:
        out[:, 3] = packed >> 24
    return out.reshape(-1)
