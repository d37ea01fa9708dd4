"""K1 and K5: exact batched QOI chunk replay, and K6 log-fill (CUDA kernels
csrc/replay.cu and csrc/logfill.cu).

Per lane (image), a strict in-order walk over C chunk rows carrying the
previous pixel and the 64-entry running index; see csrc/replay.cu for the
transition rules.  Chunk rows are (C, B) int32, chunk-major (contiguous)
or lane-major (the transpose of a contiguous (B, C) plane, as the decode
passes make them), or a slice of either; the kernels read them at their
strides:

  meta = cls | arg << 3 | rst << 9   cls: 0 NOP, 1 SETA, 2 SETC, 3 ADD,
                                          4 IDX, 5 RUN; rst re-enters the
                                          decoder's start state
  val  = absolute RGBA (SETA), RGB with a zero alpha byte (SETC), or the
         per-byte delta (ADD)
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import tracing
from .bitops import ALPHA_MASK, START_PIXEL_PACKED

_START_HASH = (11 * 255) % 64

CLS_NOP, CLS_SETA, CLS_SETC, CLS_ADD, CLS_IDX, CLS_RUN = range(6)

# csrc/logfill.cu: words a warp walks (kSeg), warps a block (kWarps)
LOGFILL_SEGMENT, LOGFILL_WARPS = 512, 8


def initial_state(b: int, device=None):
    """The decoder's initial carry: prev (1, B) = start pixel; seen (64, B)
    zero except slot 53, which holds the start pixel (reference quirk)."""
    prev0 = torch.full((1, b), START_PIXEL_PACKED, dtype=torch.int32,
                       device=device)
    seen0 = torch.zeros((64, b), dtype=torch.int32, device=device)
    seen0[_START_HASH] = START_PIXEL_PACKED
    return prev0, seen0


def _bytes(w):
    """(B,) int32 words -> (B, 4) uint8 views of their bytes (r, g, b, a)."""
    return w.view(torch.uint8).reshape(-1, 4)


def _replay_reference(meta, val, prev_in, seen_in, summary: bool):
    """The row loop shared by the plain versions of K1 and K5.  The class
    masks are decoded for all rows at once; a row's step skips the terms
    of the classes it does not hold."""
    # rows in chunk-major memory: a lane-major view of a single lane (B =
    # 1) counts as contiguous but keeps its row stride, and _bytes cannot
    # view such a row as bytes
    meta, val = (x.clone(memory_format=torch.contiguous_format)
                 for x in (meta, val))
    c, b = meta.shape
    dev = meta.device
    lanes = torch.arange(b, device=dev)
    weights = torch.tensor([3, 5, 7, 11], dtype=torch.int32, device=dev)
    prev = prev_in[0].clone()
    seen = seen_in.clone()
    start_seen = initial_state(b, dev)[1]
    emits = torch.empty_like(meta)
    pupd = torch.zeros(b, dtype=torch.bool, device=dev)
    swr = torch.zeros((64, b), dtype=torch.bool, device=dev)

    cls = meta & 7
    rst = ((meta >> 9) & 1) == 1
    arg = (meta >> 3) & 63
    is_set = (cls == CLS_SETA) | (cls == CLS_SETC)
    is_setc = cls == CLS_SETC
    is_add = cls == CLS_ADD
    is_idx = cls == CLS_IDX
    upd = is_set | is_add | is_idx
    any_rst, any_set, any_add, any_idx, any_upd = (
        m.any(dim=1).tolist() for m in (rst, is_set, is_add, is_idx, upd))
    for t in range(c):
        x = val[t]
        if any_rst[t]:  # stream-start reset: the decoder's initial state
            r = rst[t]
            prev = torch.where(r, START_PIXEL_PACKED, prev)
            seen = torch.where(r[None, :], start_seen, seen)
            if summary:  # a reset overwrites every state component
                pupd |= r
                swr |= r[None, :]
        if not any_upd[t]:  # NOP and RUN rows repeat prev
            emits[t] = prev
            continue
        v = prev
        if any_set[t]:
            v = torch.where(is_set[t], torch.where(
                is_setc[t], (prev & ALPHA_MASK) | x, x), v)
        if any_add[t]:  # per-byte wraparound addition
            v = torch.where(is_add[t], (_bytes(prev) + _bytes(x)).view(
                torch.int32).reshape(b), v)
        if any_idx[t]:
            v = torch.where(is_idx[t], seen[arg[t], lanes], v)
        # v == prev on the lanes that do not update, so prev = v
        prev = v
        u = upd[t]
        h = (_bytes(v).to(torch.int32) * weights).sum(dim=1) & 63
        seen[h, lanes] = torch.where(u, v, seen[h, lanes])
        if summary:
            pupd |= u
            swr[h, lanes] |= u
        emits[t] = v
    out = (emits, prev[None, :], seen)
    if summary:
        out += (pupd[None, :].to(torch.int32), swr.to(torch.int32))
    return out


def replay_batch_carry_reference(meta, val, prev_in, seen_in):
    """Plain version of K1: a Python loop over the C rows, vectorised over
    the B lanes.  Same arguments and results as replay_batch_carry (its
    emits chunk-major whatever the rows' layout)."""
    return _replay_reference(meta, val, prev_in, seen_in, summary=False)


def replay_batch_summary_reference(meta, val, prev_in, seen_in):
    """Plain version of K5: K1's row loop plus the transfer summaries.
    Same arguments and results as replay_batch_summary (its emits
    chunk-major whatever the rows' layout)."""
    return _replay_reference(meta, val, prev_in, seen_in, summary=True)


def _check_replay_args(meta, val, prev_in, seen_in):
    """Check the rows and the carry; returns (C, B, device, the rows'
    (row, lane) element strides).  meta and val are (C, B) int32 views
    with equal strides, in any layout: chunk-major (contiguous), lane-major
    (the transpose of a contiguous (B, C) plane), or a slice of either."""
    c, b = meta.shape
    dev = meta.device
    for t, name in ((meta, "meta"), (val, "val")):
        kernels.check(t, name, torch.int32, (c, b), dev, contiguous=False)
    if meta.stride() != val.stride():
        raise ValueError(f"meta and val strides differ: {meta.stride()} vs "
                         f"{val.stride()}")
    kernels.check(prev_in, "prev_in", torch.int32, (1, b), dev)
    kernels.check(seen_in, "seen_in", torch.int32, (64, b), dev)
    return c, b, dev, meta.stride()


def _emits_like(meta):
    """Uninitialised (C, B) int32 emits, lane-major where meta's rows lie
    closer than its lanes (the kernel then stores them coalesced), else
    chunk-major.  Returns them and their strides."""
    c, b = meta.shape
    rs, ls = meta.stride()
    if c > 1 and b > 1 and rs < ls:
        out = torch.empty((b, c), dtype=torch.int32, device=meta.device).T
    else:
        out = torch.empty((c, b), dtype=torch.int32, device=meta.device)
    return out, out.stride()


def replay_batch_carry(meta, val, prev_in, seen_in):
    """Carried-state replay of a window of chunk rows.

    meta/val: (C, B) int32 views with equal strides: chunk-major, lane-major
    (the transpose of a contiguous (B, C) plane) or a slice of either;
    prev_in (1, B) and seen_in (64, B) int32.  Returns (emits (C, B), from
    the kernel lane-major for lane-major rows, else chunk-major; prev_out
    (1, B), seen_out (64, B)), int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if meta.device.type == "cpu":
        return replay_batch_carry_reference(meta, val, prev_in, seen_in)
    c, b, dev, strides = _check_replay_args(meta, val, prev_in, seen_in)
    emits, emit_strides = _emits_like(meta)
    prev_out = torch.empty_like(prev_in)
    seen_out = torch.empty_like(seen_in)
    if b:
        kernels.launch(
            "replay", "qk_replay", dev,
            meta.data_ptr(), val.data_ptr(), prev_in.data_ptr(),
            seen_in.data_ptr(), emits.data_ptr(), prev_out.data_ptr(),
            seen_out.data_ptr(), c, b, *strides, *emit_strides)
    return emits, prev_out, seen_out


@tracing.traced("decode.replay")
def replay_batch(meta, val):
    """meta/val: (C, B) int32 chunk rows (chunk-major).  Returns emits
    (C, B) int32: the value each row produces from the start state (a RUN
    or NOP row repeats the running pixel)."""
    prev0, seen0 = initial_state(meta.shape[1], meta.device)
    return replay_batch_carry(meta, val, prev0, seen0)[0]


def replay_batch_summary(meta, val, prev_in, seen_in):
    """K5: carried-state replay that also returns each lane's transfer
    summary, the seam algebra of split-replay (models/split.py).

    meta/val: (C, B) int32 views as K1 takes them; prev_in (1, B) and
    seen_in (64, B) int32.  Returns (emits (C, B) laid out as K1's,
    prev_out (1, B), seen_out (64, B), pupd (1, B), swr (64, B)), int32:
    pupd is 1 where the lane overwrote prev, swr 1
    where it overwrote a table slot (a reset overwrites all of them).  A
    lane's out-state component equals its in-state component exactly where
    the summary bit is 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if meta.device.type == "cpu":
        return replay_batch_summary_reference(meta, val, prev_in, seen_in)
    c, b, dev, strides = _check_replay_args(meta, val, prev_in, seen_in)
    emits, emit_strides = _emits_like(meta)
    prev_out = torch.empty_like(prev_in)
    seen_out = torch.empty_like(seen_in)
    pupd = torch.empty_like(prev_in)
    swr = torch.empty_like(seen_in)
    if b:
        kernels.launch(
            "replay_summary", "qk_replay_summary", dev,
            meta.data_ptr(), val.data_ptr(), prev_in.data_ptr(),
            seen_in.data_ptr(), emits.data_ptr(), prev_out.data_ptr(),
            seen_out.data_ptr(), pupd.data_ptr(), swr.data_ptr(), c, b,
            *strides, *emit_strides)
    return emits, prev_out, seen_out, pupd, swr


def logfill_batch_reference(words):
    """Plain version of K6: six doubling passes."""
    f = words
    for k in (1, 2, 4, 8, 16, 32):
        shifted = torch.nn.functional.pad(f[:, :-k], (k, 0))
        f = torch.where(f < 0, f, shifted)  # bit 31 set: a written slot
    return f


def logfill_batch(words):
    """K6: fill each word from the nearest flagged word (bit 31 set) at
    most 63 slots to its left, along each row.

    words: (B, n) int32 whose unflagged words are 0 (what the decoder's
    expansion gives it).  Returns (B, n) int32: out[w] is the nearest
    flagged word in [w - 63, w], else 0 (in general: else words[w - 63],
    0 before the row start, which is what the six doubling passes of the
    plain version give for any input).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if words.device.type == "cpu":
        return logfill_batch_reference(words)
    b, n = words.shape
    dev = words.device
    kernels.check(words, "words", torch.int32, (b, n), dev)
    out = torch.empty_like(words)
    if b and n:
        kernels.launch("logfill", "qk_logfill", dev, words.data_ptr(),
                       out.data_ptr(), b, n)
    return out
