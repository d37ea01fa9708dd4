"""Byte-domain chunk fields, pixel expansion and the one-stream decoder.

Of ``qoipp_tpu.ops.decode`` the port holds:

- ``fields_dense_batch``: every byte position of a region carries a
  (meta, val) row for the replay kernels (ops/replay_kernel.py); positions
  that start no real chunk are NOP rows;
- ``expand_bytes_batch``: replay emits -> pixels, by an opaque engine
  (scatter-set of flagged words, then K6 log-fill) or a general one
  (telescoping deltas, scatter-add, cumsum mod 2^32);
- ``decode_single``: one stream through the boundary pass, K1 on one lane
  and the expansion, with the reference's tolerant truncated-input rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import Channels, Desc
from . import boundary
from . import classify as cls_ops
from . import replay_kernel as rk
from .bitops import START_PIXEL_PACKED, packed_to_pixels
from .fill import fill_forward

_U32 = 1 << 32


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


def _u32_to_i32(x):
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - _U32, x).to(torch.int32)


def _cover_index(real, produced, pix_before, n_cap: int):
    """The expansion's scatter map: covers (B, qb) bool, the rows that place
    a chunk below n_cap, and flat (B * qb,) int64, each row's offset in a
    (B, n_cap + 1) plane whose last column takes the rows past n_cap."""
    b = real.shape[0]
    covers = real & (produced > 0) & (pix_before < n_cap)
    # pix_before is nondecreasing over all byte rows; the clamp sends rows
    # past n_cap to the dropped column n_cap
    idx = torch.clamp(pix_before, max=n_cap).to(torch.int64)
    rows = torch.arange(b, device=real.device)[:, None] * (n_cap + 1)
    return covers, (idx + rows).reshape(-1)


def flagged_words(emits, real, produced, pix_before, n_cap: int):
    """The opaque engine's input to K6: (B, n_cap) int32 with bit 31 | rgb
    of the covering chunk at each chunk's first pixel, 0 elsewhere.

    Every byte row carries the next covered chunk's rgb (a fill backward,
    as a fill forward on the flipped axis), so the rows that share a
    pixel offset write equal words and the scatter-set is exact."""
    b = emits.shape[0]
    covers, flat = _cover_index(real, produced, pix_before, n_cap)
    rgb = (emits & 0xFFFFFF).flip(1)
    fcov = covers.flip(1)
    (nxt,), got, _ = fill_forward([(rgb, 24)], fcov, fcov)
    word = torch.where(got, nxt | (-(1 << 31)), 0).flip(1)
    f = torch.zeros(b * (n_cap + 1), dtype=torch.int32, device=emits.device)
    f.scatter_(0, flat, word.reshape(-1))
    return f.reshape(b, n_cap + 1)[:, :n_cap].contiguous()


def expand_bytes_batch(emits, real, produced, pix_before, n_cap: int):
    """Byte-domain expansion of replay emits to (B, n_cap) int32 pixels.

    emits/produced/pix_before: (B, qb) int32 (NOP rows emit the running
    prev); real: (B, qb) bool.  The engine is chosen per call, on the
    actual emits (one host sync):

    * opaque, when every emit's alpha is 0xFF: a scatter-set of flagged
      words, then K6 fills each RUN gap (<= 61 pixels) from its chunk;
    * general: each covering chunk adds its delta from the previous
      emit at its pixel offset, and a cumsum mod 2^32 telescopes them back
      to absolute words (held in int64, masked to 32 bits)."""
    if bool((((emits >> 24) & 0xFF) == 0xFF).all()):
        f = rk.logfill_batch(flagged_words(emits, real, produced, pix_before,
                                           n_cap))
        return (f & 0xFFFFFF) | START_PIXEL_PACKED

    b = emits.shape[0]
    covers, flat = _cover_index(real, produced, pix_before, n_cap)
    e = emits.to(torch.int64) & 0xFFFFFFFF
    prevv = torch.cat([torch.full((b, 1), START_PIXEL_PACKED & 0xFFFFFFFF,
                                  dtype=torch.int64, device=emits.device),
                       e[:, :-1]], dim=1)
    delta = torch.where(covers, (e - prevv) & 0xFFFFFFFF, 0)
    out0 = torch.zeros(b * (n_cap + 1), dtype=torch.int64,
                       device=emits.device)
    out0.index_add_(0, flat, delta.reshape(-1))
    acc = torch.cumsum(out0.reshape(b, n_cap + 1)[:, :n_cap], dim=1)
    return _u32_to_i32((acc + (START_PIXEL_PACKED & 0xFFFFFFFF)) & 0xFFFFFFFF)


def _bucket(n: int, lo: int = 128) -> int:
    """A power of two of lo, or 3/4 or 7/8 of it, whichever first holds n
    (the JAX package's analysis-window and pixel-cap buckets)."""
    n = max(n, lo)
    b = lo
    while b < n:
        b *= 2
    for frac in (3 * b // 4, 7 * b // 8):
        if frac >= n and frac % lo == 0:
            return frac
    return b


def single_lane_inputs(data, desc: Desc, device):
    """The stages of decode_single before K1: the boundary pass over a
    window widened until the image's pixels are owed, and the dense
    fields.  Returns K1's rows (meta, val), each (qb, 1) int32, real,
    produced and pix_before, each (1, qb), and n_cap, the pixel bucket."""
    data = np.asarray(data, dtype=np.uint8).reshape(-1)
    size = int(data.size)
    n_px = desc.width * desc.height

    def run_analysis(qb: int):
        reg = np.zeros(qb + 8, dtype=np.uint8)
        reg[: size - 14] = data[14:]
        region = torch.from_numpy(reg).to(device)
        return region, boundary.analyze_region(region[:qb], size - 22, n_px), qb

    region, info, qb = run_analysis(_bucket(size - 14, boundary.BLOCK))
    total_px = int(info["total_pixels"])
    while total_px < n_px:
        # each zero byte yields one pixel, so widening by the deficit ends
        region, info, qb = run_analysis(
            _bucket(qb + (n_px - total_px) + 8, boundary.BLOCK))
        total_px = int(info["total_pixels"])

    real = info["real"][None]
    meta, val = fields_dense_batch(region[None], real)
    return (meta.reshape(-1, 1), val.reshape(-1, 1), real,
            info["produced"][None], info["pix_before"][None],
            _bucket(n_px, 128))


def expansion_inputs(data, desc: Desc, device):
    """single_lane_inputs and K1 on its one lane: returns (emits, real,
    produced, pix_before), each (1, qb), and n_cap, the pixel bucket."""
    meta, val, real, produced, pix_before, n_cap = single_lane_inputs(
        data, desc, device)
    emits = rk.replay_batch(meta, val)
    return emits.reshape(1, -1), real, produced, pix_before, n_cap


def decode_single(data, desc: Desc, dst_channels: Channels, device=None
                  ) -> np.ndarray:
    """Decode one QOI stream -> raw bytes (numpy), bit-exact with the
    reference decoder, truncated streams included: bytes past the stream
    read as zeros (INDEX-0 chunks) until the image's pixels are produced.
    Runs on ``device`` (None means "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    packed = expand_bytes_batch(*expansion_inputs(data, desc, dev))[0]
    n_px = desc.width * desc.height
    return packed_to_pixels(packed[:n_px], int(dst_channels)).cpu().numpy()
