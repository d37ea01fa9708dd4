"""Per-byte-position chunk-kind classification (shifted slices, no gathers).

Every byte position of a stream region is classified as a chunk kind with
its payload fields; positions that do not start a real chunk become NOPK.
Kinds follow the reference decoder's switch: SETA = OP_RGBA, SETC = OP_RGB
(alpha passes through), ADDK = OP_DIFF/OP_LUMA (per-channel mod-256
delta), IDXK = OP_INDEX, RUNK = OP_RUN.
"""

from __future__ import annotations

import torch

# chunk kinds
NOPK, SETA, SETC, ADDK, IDXK, RUNK = 0, 1, 2, 3, 4, 5


def classify_kinds(region, qb: int, real):
    """Chunk kinds + payload fields of the first qb positions of region
    (..., >= qb + 4) uint8; real (..., qb) bool masks non-chunk positions.

    Returns (kind, (r, g, b, a) absolute bytes, (dr, dg, db) deltas, arg),
    all int32 of shape (..., qb)."""
    tag = region[..., :qb].to(torch.int32)
    b1, b2, b3, b4 = (region[..., k : qb + k].to(torch.int32)
                      for k in range(1, 5))

    is_rgb = tag == 0xFE
    is_rgba = tag == 0xFF
    top = tag & 0xC0
    named = is_rgb | is_rgba
    is_index = ~named & (top == 0x00)
    is_diff = ~named & (top == 0x40)
    is_luma = ~named & (top == 0x80)
    is_run = ~named & (top == 0xC0)

    kind = torch.where(
        is_rgba, SETA,
        torch.where(is_rgb, SETC,
                    torch.where(is_diff | is_luma, ADDK,
                                torch.where(is_index, IDXK,
                                            torch.where(is_run, RUNK, NOPK)))))
    kind = torch.where(real, kind, NOPK).to(torch.int32)

    diff_dr = (((tag >> 4) & 3) - 2) & 0xFF
    diff_dg = (((tag >> 2) & 3) - 2) & 0xFF
    diff_db = ((tag & 3) - 2) & 0xFF
    vg = (tag & 0x3F) - 32
    luma_dr = (vg + ((b1 >> 4) & 0xF) - 8) & 0xFF
    luma_dg = vg & 0xFF
    luma_db = (vg + (b1 & 0xF) - 8) & 0xFF

    is_add = kind == ADDK
    dr = torch.where(is_add, torch.where(is_diff, diff_dr, luma_dr), 0)
    dg = torch.where(is_add, torch.where(is_diff, diff_dg, luma_dg), 0)
    db = torch.where(is_add, torch.where(is_diff, diff_db, luma_db), 0)

    arg = torch.where(kind == IDXK, tag & 0x3F, 0)
    return kind, (b1, b2, b3, b4), (dr, dg, db), arg
