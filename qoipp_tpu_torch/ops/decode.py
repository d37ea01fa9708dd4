"""Byte-domain chunk fields for the replay kernel.

Of ``qoipp_tpu.ops.decode`` the main path needs only the dense field pass:
every byte position of a region carries a (meta, val) row for the replay
kernel (ops/replay_kernel.py) and positions that start no real chunk are
NOP rows.
"""

from __future__ import annotations

import torch

from . import classify as cls_ops


def fields_dense_batch(regions, real):
    """regions (B, >= qb + 4) uint8, real (B, qb) bool -> (meta, val), both
    (B, qb) int32.

    meta = kind | arg << 3 (bit 9, the stream-start reset, stays 0 here);
    val  = absolute RGBA (SETA), RGB with a zero alpha byte (SETC), or the
           per-byte delta (ADD)."""
    qb = real.shape[1]
    kind, (r_abs, g_abs, b_abs, a_abs), (dr, dg, db), arg = (
        cls_ops.classify_kinds(regions, qb, real))
    meta = kind | (arg << 3)
    rgb = r_abs | (g_abs << 8) | (b_abs << 16)
    val = torch.where(
        kind == cls_ops.SETA, rgb | (a_abs << 24),
        torch.where(kind == cls_ops.SETC, rgb, dr | (dg << 8) | (db << 16)),
    )
    return meta, val
