"""The plain QOI reference of the benchmark: the format as qoiformat.org's
``qoi.h`` writes it, in plain PyTorch (any device) and plain Python.

``encode`` is vectorised: every pixel's op follows from its previous
pixel and from the last earlier pixel with the same colour hash, which a
sort by (hash, position) finds, so one image is some forty tensor passes.
``decode`` is the format's sequential loop in plain Python, used only to
turn the committed corpus files into raw pixels once (the result is
cached by ``corpus.py``) and by the tests.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

MAGIC = b"qoif"
END_MARKER = bytes([0, 0, 0, 0, 0, 0, 0, 1])
OP_INDEX, OP_DIFF, OP_LUMA, OP_RUN, OP_RGB, OP_RGBA = (
    0x00, 0x40, 0x80, 0xC0, 0xFE, 0xFF)
START_WORD = 0xFF << 24  # r = g = b = 0, a = 255


class Header(NamedTuple):
    width: int
    height: int
    channels: int
    colorspace: int


class Encoded(NamedTuple):
    """One encoded image and what its encoding needs: ``ops`` chunks
    (the decoder's chunk rows), ``kept`` pixels that start a chunk or
    flush a 62-pixel run (the encoder's compacted rows)."""
    stream: torch.Tensor  # uint8, header to end marker
    ops: int
    kept: int


def header_bytes(h: Header) -> bytes:
    return MAGIC + struct.pack(">IIBB", h.width, h.height, h.channels,
                               h.colorspace)


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    return np.ascontiguousarray(data, np.uint8).tobytes()


def read_header(data) -> Header:
    raw = _as_bytes(data[:14])
    if len(raw) < 14 or raw[:4] != MAGIC:
        raise ValueError("not a QOI stream")
    w, h, c, cs = struct.unpack(">IIBB", raw[4:])
    if c not in (3, 4) or cs > 1 or not w or not h:
        raise ValueError(f"invalid QOI header {w}x{h} c={c} cs={cs}")
    return Header(w, h, c, cs)


def _signed8(x):
    x = x & 0xFF
    return torch.where(x >= 128, x - 256, x)


def encode(pixels: torch.Tensor, header: Header,
           index_ops: bool = True) -> Encoded:
    """(n_px * channels,) uint8 pixels on any device -> the QOI stream as
    ``qoi.h`` writes it, on the same device.  ``index_ops=False`` never
    emits INDEX: a valid stream that decodes to the same pixels but is not
    the reference encoder's bytes (the benchmark's control)."""
    ch = header.channels
    n = header.width * header.height
    dev = pixels.device
    px = pixels.reshape(n, ch).to(torch.int64)
    r, g, b = px[:, 0], px[:, 1], px[:, 2]
    a = px[:, 3] if ch == 4 else torch.full_like(r, 255)
    word = r | (g << 8) | (b << 16) | (a << 24)
    prev = torch.cat([torch.full((1,), START_WORD, dtype=torch.int64,
                                 device=dev), word[:-1]])
    pr, pg, pb, pa = (prev & 0xFF, (prev >> 8) & 0xFF, (prev >> 16) & 0xFF,
                      prev >> 24)
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    same = word == prev
    noneq = ~same
    # runs: a same pixel's place in its run; the run is written at its
    # 62nd pixel and at its last
    last_noneq = torch.cummax(torch.where(noneq, idx, -1), 0).values
    run_pos = idx - last_noneq
    ends_run = torch.cat([noneq[1:], torch.ones(1, dtype=torch.bool,
                                                device=dev)])
    at62 = same & (run_pos % 62 == 0)
    emit_run = same & ((run_pos % 62 == 0) | ends_run)
    run_len = torch.where(run_pos % 62 == 0, 62, run_pos % 62)

    # INDEX: after any pixel from the first differing one on, the table
    # slot of its hash holds it; pixels before that (a leading run of the
    # start pixel) never wrote.  So a pixel's slot holds the last earlier
    # pixel of the same hash from there on, or 0.
    h = (r * 3 + g * 5 + b * 7 + a * 11) % 64
    nz = torch.nonzero(noneq)
    first = int(nz[0, 0]) if nz.numel() else n
    hk = torch.where(idx >= first, h, 64)
    order = torch.sort(hk * n + idx).indices
    hs = hk[order]
    pred_sorted = torch.cat([torch.full((1,), -1, dtype=torch.int64,
                                        device=dev), order[:-1]])
    pred_sorted = torch.where(
        torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                   hs[1:] == hs[:-1]]), pred_sorted, -1)
    pred = torch.empty_like(order)
    pred[order] = pred_sorted
    slot = torch.where(pred >= 0, word[pred.clamp(min=0)], 0)
    is_index = noneq & (slot == word)
    if not index_ops:
        is_index = torch.zeros_like(is_index)

    vr, vg, vb = _signed8(r - pr), _signed8(g - pg), _signed8(b - pb)
    vg_r, vg_b = vr - vg, vb - vg
    plain = noneq & ~is_index
    same_a = a == pa
    is_diff = plain & same_a & (vr >= -2) & (vr <= 1) & (vg >= -2) & (
        vg <= 1) & (vb >= -2) & (vb <= 1)
    is_luma = plain & same_a & ~is_diff & (vg >= -32) & (vg <= 31) & (
        vg_r >= -8) & (vg_r <= 7) & (vg_b >= -8) & (vg_b <= 7)
    is_rgb = plain & same_a & ~is_diff & ~is_luma
    is_rgba = plain & ~same_a

    length = (emit_run.long() + is_index.long() + is_diff.long()
              + 2 * is_luma.long() + 4 * is_rgb.long() + 5 * is_rgba.long())
    off = torch.cumsum(length, 0) - length + 14
    body = int(length.sum())
    out = torch.zeros(14 + body + 8, dtype=torch.int64, device=dev)
    out[:14] = torch.tensor(list(header_bytes(header)), dtype=torch.int64,
                            device=dev)
    out[-1] = 1
    b0 = torch.where(emit_run, OP_RUN | (run_len - 1), 0)
    b0 = torch.where(is_index, OP_INDEX | h, b0)
    b0 = torch.where(is_diff, OP_DIFF | ((vr + 2) << 4) | ((vg + 2) << 2)
                     | (vb + 2), b0)
    b0 = torch.where(is_luma, OP_LUMA | (vg + 32), b0)
    b0 = torch.where(is_rgb, OP_RGB, b0)
    b0 = torch.where(is_rgba, OP_RGBA, b0)
    emits = length > 0
    out[off[emits]] = b0[emits]
    out[off[is_luma] + 1] = ((vg_r + 8) << 4 | (vg_b + 8))[is_luma]
    wide = is_rgb | is_rgba
    for k, chan in enumerate((r, g, b), start=1):
        out[off[wide] + k] = chan[wide]
    out[off[is_rgba] + 4] = a[is_rgba]
    ops = int(emits.sum())
    kept = int(noneq.sum()) + int(at62.sum())
    return Encoded(out.to(torch.uint8), ops, kept)


def _hash(px: int) -> int:
    return ((px & 0xFF) * 3 + ((px >> 8) & 0xFF) * 5
            + ((px >> 16) & 0xFF) * 7 + (px >> 24) * 11) % 64


def decode(data) -> np.ndarray:
    """A QOI stream (bytes or uint8 array) -> its (n_px * channels,)
    uint8 pixels, by the format's sequential loop.  Strict: the stream
    must hold exactly the image's pixels and then the end marker."""
    buf = _as_bytes(data)
    hd = read_header(buf)
    n = hd.width * hd.height
    ch = hd.channels
    out = bytearray(n * 4)
    index = [0] * 64
    px = START_WORD
    p, end, i = 14, len(buf) - 8, 0
    n4 = n * 4
    while i < n4:
        if p >= end:
            raise ValueError("QOI stream ends before its pixels")
        b1 = buf[p]
        p += 1
        if b1 == OP_RGB:
            px = (px & 0xFF000000) | buf[p] | (buf[p + 1] << 8) | (
                buf[p + 2] << 16)
            p += 3
        elif b1 == OP_RGBA:
            px = buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16) | (
                buf[p + 3] << 24)
            p += 4
        else:
            tag = b1 & 0xC0
            if tag == OP_INDEX:
                px = index[b1]
            elif tag == OP_DIFF:
                px = ((px & 0xFF000000)
                      | ((px + ((b1 >> 4) & 3) - 2) & 0xFF)
                      | (((px >> 8) + ((b1 >> 2) & 3) - 2) & 0xFF) << 8
                      | (((px >> 16) + (b1 & 3) - 2) & 0xFF) << 16)
            elif tag == OP_LUMA:
                b2 = buf[p]
                p += 1
                vg = (b1 & 0x3F) - 32
                dr = vg - 8 + ((b2 >> 4) & 0x0F)
                db = vg - 8 + (b2 & 0x0F)
                px = ((px & 0xFF000000)
                      | ((px + dr) & 0xFF)
                      | (((px >> 8) + vg) & 0xFF) << 8
                      | (((px >> 16) + db) & 0xFF) << 16)
            else:  # RUN: the previous pixel, (b1 & 0x3F) + 1 times
                k = min((b1 & 0x3F) + 1, (n4 - i) // 4)
                out[i:i + 4 * k] = px.to_bytes(4, "little") * k
                i += 4 * k
                # qoi.h stores every chunk's pixel, a RUN's too
                index[_hash(px)] = px
                continue
        index[_hash(px)] = px
        out[i:i + 4] = px.to_bytes(4, "little")
        i += 4
    if buf[p:] != END_MARKER:
        raise ValueError("QOI stream does not end with the end marker "
                         "after its pixels")
    rgba = np.frombuffer(bytes(out), np.uint8).reshape(n, 4)
    return np.ascontiguousarray(rgba[:, :ch]).reshape(-1)
