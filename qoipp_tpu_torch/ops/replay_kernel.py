"""K1: exact batched QOI chunk replay (CUDA kernel csrc/replay.cu).

Per lane (image), a strict in-order walk over C chunk rows carrying the
previous pixel and the 64-entry running index; see csrc/replay.cu for the
transition rules.  Chunk rows are chunk-major (C, B) int32:

  meta = cls | arg << 3 | rst << 9   cls: 0 NOP, 1 SETA, 2 SETC, 3 ADD,
                                          4 IDX, 5 RUN; rst re-enters the
                                          decoder's start state
  val  = absolute RGBA (SETA), RGB with a zero alpha byte (SETC), or the
         per-byte delta (ADD)
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitops import ALPHA_MASK, START_PIXEL_PACKED, hash6, swar_add_bytes

_START_HASH = (11 * 255) % 64

CLS_NOP, CLS_SETA, CLS_SETC, CLS_ADD, CLS_IDX, CLS_RUN = range(6)


def initial_state(b: int, device=None):
    """The decoder's initial carry: prev (1, B) = start pixel; seen (64, B)
    zero except slot 53, which holds the start pixel (reference quirk)."""
    prev0 = torch.full((1, b), START_PIXEL_PACKED, dtype=torch.int32,
                       device=device)
    seen0 = torch.zeros((64, b), dtype=torch.int32, device=device)
    seen0[_START_HASH] = START_PIXEL_PACKED
    return prev0, seen0


def replay_batch_carry_reference(meta, val, prev_in, seen_in):
    """Plain version of K1: a Python loop over the C rows, vectorised over
    the B lanes.  Same arguments and results as replay_batch_carry."""
    c, b = meta.shape
    lanes = torch.arange(b, device=meta.device)
    prev = prev_in[0].clone()
    seen = seen_in.clone()
    start_seen = initial_state(b, meta.device)[1]
    emits = torch.empty_like(meta)
    for t in range(c):
        m, x = meta[t], val[t]
        cls = m & 7
        rst = ((m >> 9) & 1) == 1
        prev = torch.where(rst, START_PIXEL_PACKED, prev)
        seen = torch.where(rst[None, :], start_seen, seen)
        idx_val = seen[(m >> 3) & 63, lanes]
        set_val = torch.where(cls == CLS_SETC, (prev & ALPHA_MASK) | x, x)
        v = torch.where(
            (cls == CLS_SETA) | (cls == CLS_SETC), set_val,
            torch.where(cls == CLS_ADD, swar_add_bytes(prev, x),
                        torch.where(cls == CLS_IDX, idx_val, prev)))
        upd = (cls >= CLS_SETA) & (cls <= CLS_IDX)
        prev = torch.where(upd, v, prev)
        h = hash6(v)
        seen[h, lanes] = torch.where(upd, v, seen[h, lanes])
        emits[t] = v
    return emits, prev[None, :], seen


def replay_batch_carry(meta, val, prev_in, seen_in):
    """Carried-state replay of a window of chunk rows.

    meta/val: (C, B) int32; prev_in (1, B) and seen_in (64, B) int32.
    Returns (emits (C, B), prev_out (1, B), seen_out (64, B)), int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if meta.device.type == "cpu":
        return replay_batch_carry_reference(meta, val, prev_in, seen_in)
    c, b = meta.shape
    dev = meta.device
    kernels.check(meta, "meta", torch.int32, (c, b), dev)
    kernels.check(val, "val", torch.int32, (c, b), dev)
    kernels.check(prev_in, "prev_in", torch.int32, (1, b), dev)
    kernels.check(seen_in, "seen_in", torch.int32, (64, b), dev)
    emits = torch.empty_like(meta)
    prev_out = torch.empty_like(prev_in)
    seen_out = torch.empty_like(seen_in)
    if b:
        kernels.launch(
            "replay", "qk_replay", dev,
            meta.data_ptr(), val.data_ptr(), prev_in.data_ptr(),
            seen_in.data_ptr(), emits.data_ptr(), prev_out.data_ptr(),
            seen_out.data_ptr(), c, b)
    return emits, prev_out, seen_out


def replay_batch(meta, val):
    """meta/val: (C, B) int32 chunk rows (chunk-major).  Returns emits
    (C, B) int32: the value each row produces from the start state (a RUN
    or NOP row repeats the running pixel)."""
    prev0, seen0 = initial_state(meta.shape[1], meta.device)
    return replay_batch_carry(meta, val, prev0, seen0)[0]
