"""Byte-domain chunk fields, pixel expansion and the one-stream decoder.

Of ``qoipp_tpu.ops.decode`` the port holds:

- ``fields_dense_batch``: every byte position of a region carries a
  (meta, val) row for the replay kernels (ops/replay_kernel.py); positions
  that start no real chunk are NOP rows;
- ``expand_bytes_batch``: replay emits -> pixels, by an opaque engine
  (scatter-set of flagged words, then K6 log-fill) or a general one
  (telescoping deltas, scatter-add, cumsum mod 2^32);
- ``decode_single``: one stream through the boundary pass, K1 on one lane
  and the expansion, with the reference's tolerant truncated-input rule;
- the seam algebra of speculative replay: ``true_init_row``,
  ``propagate`` and ``seam_fixpoint`` (K5 rounds until every lane's
  in-state is implied by the lanes before it), which split-replay, the
  streaming decoder and the sequence-parallel decode share;
- the scan-fixpoint engine ``decode_bytes``: one stream's byte rows cut
  into S tiles, replayed as S lanes of K5 from the JAX package's guess
  and reconciled by ``seam_fixpoint``, then ``expand_pixels``, and
  ``pick_tiles``, its tile count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import Channels, Desc
from ..utils import tracing
from ..utils.transfer import read_flag
from . import boundary
from . import classify as cls_ops
from . import replay_kernel as rk
from .bitops import START_PIXEL_PACKED, packed_to_pixels
from .fill import fill_forward

_U32 = 1 << 32


@tracing.traced("decode.fields")
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

    return _telescope(emits, _shifted(emits), real, produced, pix_before,
                      n_cap)


def _shifted(emits):
    """(B, qb) -> each row's previous emit: the start pixel, then the
    emits but the last (a row's prev before its step, in a sequential
    replay)."""
    start = torch.full_like(emits[:, :1], START_PIXEL_PACKED)
    return torch.cat([start, emits[:, :-1]], dim=1)


def _telescope(emits, prevs, real, produced, pix_before, n_cap: int):
    """The general expansion: each covering chunk adds emit - prev (mod
    2^32) at its pixel offset, and a cumsum from the start pixel
    telescopes the deltas back to absolute words; pixels inside a run get
    no delta and repeat the word before them.  (B, qb) int32 and bool in,
    (B, n_cap) int32 out; the sums are int64 masked to 32 bits."""
    b = emits.shape[0]
    covers, flat = _cover_index(real, produced, pix_before, n_cap)
    delta = torch.where(covers, (emits.to(torch.int64) - prevs.to(
        torch.int64)) & 0xFFFFFFFF, 0)
    out0 = torch.zeros(b * (n_cap + 1), dtype=torch.int64,
                       device=emits.device)
    out0.index_add_(0, flat, delta.reshape(-1))
    acc = torch.cumsum(out0.reshape(b, n_cap + 1)[:, :n_cap], dim=1)
    return _u32_to_i32((acc + (START_PIXEL_PACKED & 0xFFFFFFFF)) & 0xFFFFFFFF)


def expand_pixels(emits_q, prevs_q, real, produced, pix_before, n_cap: int):
    """One stream's emits (qb,) int32, with each row's prev before its
    step, prevs_q (qb,), onto (n_cap,) int32 pixels by the telescoping
    cumsum; real, produced and pix_before (qb,) from the boundary pass."""
    return _telescope(emits_q[None], prevs_q[None], real[None],
                      produced[None], pix_before[None], n_cap)[0]


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


def pick_tiles(qb: int) -> int:
    """Tile count of the scan engine: one tile per ~1 KiB of stream, at
    most 512, halved until it divides qb."""
    s = 1
    while s < 512 and s * 1024 < qb:
        s *= 2
    while qb % s:
        s //= 2
    return max(s, 1)


# --------------------------------------------------------------------------
# The seam algebra of speculative replay
# --------------------------------------------------------------------------


def true_init_row(device):
    """The decoder's initial state as (65,) int32: prev = the start pixel,
    then the 64 table slots, zero except slot 53, which holds the start
    pixel (the reference's quirk)."""
    prev0, seen0 = rk.initial_state(1, device)
    return torch.cat([prev0[0], seen0[:, 0]])


def propagate(heads, out_p, out_s, pupd, swr, base=None):
    """Each lane's implied in-state from the lanes' out-states and
    summaries, all as the replay kernel gives them: out_p/pupd (1, L),
    out_s/swr (64, L); heads (L,) bool marks the lanes that start a chain;
    base (65,) int32 is the state a chain starts from (prev, then the 64
    table slots), by default the decoder's initial state.

    Component c of lane k's in-state is out[j][c] for the largest j < k in
    k's chain whose summary bit for c is set, else base[c]: a segmented
    last-writer search along the lane axis, by cummax.
    Returns (in_p (1, L), in_s (64, L), fin (65,)), fin being the state
    after the last lane, by the same rule."""
    lanes = heads.shape[0]
    dev = heads.device
    if base is None:
        base = true_init_row(dev)
    j = torch.arange(lanes, device=dev)
    bits = torch.cat([pupd, swr]) != 0  # (65, L)
    outs = torch.cat([out_p, out_s])
    upto = torch.cummax(torch.where(bits, j, -1), dim=1).values
    last = torch.cat([torch.full((65, 1), -1, dtype=upto.dtype, device=dev),
                      upto[:, :-1]], dim=1)  # writers strictly before k
    start = torch.cummax(torch.where(heads, j, -1), dim=0).values
    inner = (last >= 0) & (last >= start[None, :])
    state = torch.where(inner, torch.gather(outs, 1, last.clamp(min=0)),
                        base[:, None])
    fl = upto[:, -1:]
    fin = torch.where((fl >= 0) & (fl >= start[-1]),
                      torch.gather(outs, 1, fl.clamp(min=0)), base[:, None])
    return state[:1], state[1:], fin[:, 0]


def seam_fixpoint(meta_t, val_t, heads, max_chain: int, guess, base=None):
    """Replay rounds of K5 until every lane's in-state is implied by its
    chain, at most max_chain + 2 of them, one host sync each; round 0
    starts from guess (in_p (1, L), in_s (64, L)), chains from base
    (propagate's).  Any fixpoint is the sequential result, by induction
    from each chain head, and each round makes at least one more lane of
    every chain exact, so the cap is never what ends the loop.  Returns
    the emits (width, L) of the round that found the fixpoint, the round
    count, and the state (65,) after the last lane in that round.  A round
    is one ``decode.replay`` span and one ``host.sync``; the split route's
    round count feeds the ``split_rounds`` counter (SplitDecoder.
    dispatch_staged)."""
    in_p, in_s = guess
    rounds = 0
    while True:
        with tracing.span("decode.replay"):
            emits, out_p, out_s, pupd, swr = rk.replay_batch_summary(
                meta_t, val_t, in_p, in_s)
            want_p, want_s, fin = propagate(heads, out_p, out_s, pupd, swr,
                                            base)
        rounds += 1
        # emits came from in_p/in_s: at the fixpoint they are exact
        if read_flag((want_p == in_p).all() & (want_s == in_s).all()):
            break
        if rounds >= max_chain + 2:
            break
        in_p, in_s = want_p, want_s
    return emits, rounds, fin


# --------------------------------------------------------------------------
# The scan-fixpoint engine
# --------------------------------------------------------------------------


def scan_guess(tiles: int, first: bool, device):
    """The JAX package's round-0 in-states of speculative tiles: prev = the
    start pixel and a zero table on every tile, the table seeded (slot 53)
    on the stream's first tile only, where ``first``.  Returns (in_p
    (1, tiles), in_s (64, tiles)) int32."""
    in_p, in_s = rk.initial_state(tiles, device)
    in_s[:, 1 if first else 0:] = 0
    return in_p, in_s


def lane_major_tiles(rows, tiles: int):
    """(q,) byte rows -> the (q / tiles, tiles) lane-major view K5 reads:
    tile k is rows k * q / tiles onwards (no copy)."""
    return rows.reshape(tiles, -1).T


def scan_replay(meta, val, s_tiles: int):
    """One stream's (qb,) int32 byte rows replayed as s_tiles speculative
    tiles, one K5 lane each, reconciled by seam_fixpoint as one chain from
    the decoder's initial state.  Returns (emits (qb,) in byte order, the
    round count)."""
    heads = torch.zeros(s_tiles, dtype=torch.bool, device=meta.device)
    heads[0] = True
    emits, rounds, _ = seam_fixpoint(
        lane_major_tiles(meta, s_tiles), lane_major_tiles(val, s_tiles),
        heads, s_tiles, scan_guess(s_tiles, True, meta.device))
    return emits.T.reshape(-1), rounds


def decode_bytes(region, real, produced, pix_before, n_px: int,
                 s_tiles: int, n_cap: int):
    """Pixels of one stream by the scan-fixpoint engine.

    region: (qb + 8,) uint8 (the stream's bytes from offset 14, zero
    past it); real, produced, pix_before: (qb,) from
    boundary.analyze_region; qb % s_tiles == 0.  Returns (packed (n_cap,)
    int32 pixel words, filled: the pixels the chunks produce, at most
    n_px, a 0-d tensor).  At the fixpoint each row's prev before its step
    is the emit of the row before it, so the expansion needs no second
    output of the replay."""
    qb = real.shape[0]
    if qb % s_tiles:
        raise ValueError(f"qb {qb} is not a multiple of s_tiles {s_tiles}")
    meta, val = fields_dense_batch(region[None], real[None])
    emits, _ = scan_replay(meta[0], val[0], s_tiles)
    packed = _telescope(emits[None], _shifted(emits[None]), real[None],
                        produced[None], pix_before[None], n_cap)[0]
    return packed, torch.clamp(produced.sum(), max=n_px)


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
