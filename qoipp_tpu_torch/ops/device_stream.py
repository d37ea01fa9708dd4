"""Device-resident windowed streaming codec.

The port of ``qoipp_tpu.ops.device_stream``.  A multi-MB image is decoded
or encoded window by window in bounded device memory, bit-exact with the
one-shot codec on the concatenated stream.  Between windows the codec
carries its ~260-byte state on the device (prev pixel and 64-slot table,
plus the encoder's run counter) and at most 4 leftover bytes of a torn
chunk on the host.

- Decode: each window's chunk bytes are cut across replay lanes by the
  native walker and reconciled by the seam fixpoint of split-replay, as
  one chain whose head re-enters the carried state
  (``models/split._decode_window_lanes``: K5, K3 where the chunk domain
  pays, K2).
- Encode: ``ops/encode.encode_rows`` from the carried state: E1 gives
  every pixel's template, K3 compacts the pixels that emit bytes, the
  emit stage writes them.  A window may be cut into ``split_lanes``
  sub-windows whose entering states are closed-form functions of the
  pixels (no fixpoint): prev is the previous lane's last pixel, the run
  counter a mod-62 recurrence, the table an exclusive overwrite-combine
  of per-lane last-writer summaries.

Each window's output comes to the host in one bulk fetch.

Spans and counters (``utils/tracing``): the decoder's ``host.plan``
(``plan_window``), its upload through ``stage_h2d`` (``host.upload``), the
window's device work as ``decode.window`` (its boundary passes; the
fields, fixpoint rounds and placement are the spans inside it) and its
fetch (``host.fetch``, from the ``masked_select`` that sizes it to the
numpy array: ``d2h_bytes`` and one ``host_syncs``); a counter
``stream_windows`` of one a window, ``stream_rounds`` (the window's seam
fixpoint rounds) and ``stream_lanes`` (its segments).  The encoder's
pageable upload of each window (``host.upload``: ``h2d_bytes``,
``h2d_pageable_bytes``), ``stream.carry`` around ``lane_carries``, E1 as
``encode.fields`` (``fields_rows``: L x n pixel slots), K3 as
``encode.compact``, the sentinel and offsets as ``encode.templates``
(``template_rows``), K4 and the mask as ``encode.emit``, and its fetch
as the decoder's, with ``stream_windows`` one a window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import oracle
from ..common import (
    END_MARKER,
    Channels,
    Desc,
    Error,
    Result,
    count_bytes,
    read_header,
    write_header,
)
from ..convert import resolve_device
from ..models.split import _compact_cap, _decode_window_lanes
from ..utils import tracing
from ..utils.transport import stage_h2d
from . import boundary, place_kernel
from . import replay_kernel as rk
from .bitops import hash6, packed_to_pixels, pixels_to_packed
from .decode import _bucket
from .encode import TILE, _round_up, encode_rows, pad_to_tile
from .fields_kernel import BLK, start_state


def _joined(parts) -> np.ndarray:
    """The parts end to end (a single part as it is, not copied)."""
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


class DeviceStreamDecoder:
    """Window-granular streaming QOI decoder with device-resident state.

    Each window's chunk bytes are split across up to ``split_lanes`` replay
    lanes (cost-balanced cuts from the native walker, anchored on OP_RGB /
    OP_RGBA chunks) and reconciled by the seam fixpoint; the carried state
    enters the window's first lane as its chain base.  ``windows`` lists,
    for every window decoded since initialize(), its lanes, qb, qc, n_cap,
    fixpoint rounds and max_chain.

    device: where the windows decode; None means "cuda".
    """

    def __init__(self, window_cap: int = 1 << 20,
                 pixel_cap: Optional[int] = None, split_lanes: int = 96,
                 device=None):
        self.window_cap = _round_up(window_cap, boundary.BLOCK)
        self.pixel_cap = _round_up(pixel_cap or 8 * self.window_cap,
                                   place_kernel.WIN)
        self.split_lanes = min(max(split_lanes, 1), 128)
        self.device = resolve_device(device)
        self.windows: list = []
        self.reset()

    def is_initialized(self) -> bool:
        return self._desc is not None

    def initialize(self, header_bytes,
                   target: Optional[Channels] = None) -> Result[Desc]:
        if self._desc is not None:
            return Result.err(Error.ALREADY_INITIALIZED)
        hdr = read_header(header_bytes)
        if not hdr:
            return Result.err(hdr.error())
        self._desc = hdr.value()
        self._target = target or self._desc.channels
        prev, seen = rk.initial_state(1, self.device)  # slot 53 seeded
        self._prev, self._seen = prev[0], seen[:, 0]
        self._leftover = b""
        self.windows = []
        return Result.ok(dataclasses.replace(self._desc,
                                             channels=self._target))

    @tracing.traced("host.plan")
    def plan_window(self, win: bytes):
        """The host plan of one byte window: (regions (L, qb + 8) uint8,
        seg_lens (L,) int32, byte offsets of the segments, qb, qc, n_cap,
        pixels its chunks would produce).  L is the segment count rounded
        up to 8."""
        warr = np.frombuffer(win, np.uint8)
        # at least ~512 B per segment: tiny windows take few lanes or one
        k = min(self.split_lanes, max(len(win) // 512, 1))
        byte_w, px_w = 46.0 + 2.45 * k, 0.27 * k
        offs, poffs, cis = oracle.split_points(
            warr, 1 << 60, k, byte_w, px_w,
            lookahead=max(len(win) // k // 4, 64),
            prefer_rgba=int(self._desc.channels) == 4,
        )
        nseg = len(offs) - 1
        qseg = _bucket(int(np.diff(offs).max()), 8 * boundary.BLOCK)
        qc = _compact_cap(int(np.diff(cis).max()), qseg)
        n_cap = _bucket(_round_up(max(int(np.diff(poffs).max()), 1),
                                  place_kernel.WIN), place_kernel.WIN)
        regions = np.zeros((_round_up(nseg, 8), qseg + 8), np.uint8)
        seg_lens = np.zeros(regions.shape[0], np.int32)
        for s in range(nseg):
            b0, b1 = int(offs[s]), int(offs[s + 1])
            regions[s, : b1 - b0] = warr[b0:b1]
            seg_lens[s] = b1 - b0
        return regions, seg_lens, offs, qseg, qc, n_cap, int(poffs[-1])

    def _decode_one_window(self, win: bytes):
        """Split one byte window across lanes and decode it; returns (the
        pixel bytes of its complete chunks, bytes consumed) and advances
        the carry, or (None, 0) past pixel_cap."""
        regions, seg_lens, offs, qseg, qc, n_cap, n_px = self.plan_window(win)
        if n_px > self.pixel_cap:
            return None, 0  # the caller maps it to NOT_ENOUGH_SPACE
        nseg = len(offs) - 1
        lanes = regions.shape[0]
        dev = self.device
        regions = stage_h2d(regions, dev)
        with tracing.span("decode.window"):
            packed, n_pix, consumed, prev, seen, rounds = (
                _decode_window_lanes(
                    regions, torch.from_numpy(seg_lens).to(dev), self._prev,
                    self._seen, lanes, qb=qseg, n_cap=n_cap, qc=qc))
        self.windows.append(dict(lanes=nseg, qb=qseg, qc=qc, n_cap=n_cap,
                                 rounds=rounds, max_chain=lanes))
        tracing.count("stream_windows")
        tracing.count("stream_rounds", rounds)
        tracing.count("stream_lanes", nseg)
        total_consumed = int(offs[nseg - 1]) + int(consumed[nseg - 1])
        if total_consumed == 0:
            return np.zeros(0, np.uint8), 0
        self._prev, self._seen = prev, seen
        # ONE bulk fetch: every lane's live pixels, in lane order, already
        # in the target channels
        col = torch.arange(n_cap, device=dev)[None, :]
        with tracing.span("host.fetch"):
            live = packed.masked_select(col < n_pix[:, None])
            out = packed_to_pixels(live, int(self._target)).cpu().numpy()
        tracing.count("d2h_bytes", out.nbytes)
        tracing.count("host_syncs")
        return out, total_consumed

    def decode_window(self, data) -> Result[np.ndarray]:
        """Consume a byte window (chunks only, no header or end marker);
        returns the raw pixel bytes (target channels) of its complete
        chunks.  A torn chunk at the tail is carried into the next call."""
        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        buf = self._leftover + bytes(
            data.tobytes() if isinstance(data, np.ndarray) else data)
        if len(buf) == 0:
            return Result.err(Error.EMPTY)
        out_parts = []
        pos = 0
        while pos < len(buf):
            part, consumed = self._decode_one_window(
                buf[pos : pos + self.window_cap])
            if part is None:
                return Result.err(Error.NOT_ENOUGH_SPACE)
            if consumed == 0:
                break  # only a torn chunk left
            out_parts.append(part)
            pos += consumed
        self._leftover = buf[pos:]
        return Result.ok(_joined(out_parts))

    def reset(self) -> None:
        self._desc = None
        self._target = None
        self._leftover = b""
        self._prev = None
        self._seen = None


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------


def _encode_window(raw_u8, n_px: int, prev_c, run_c, seen_c, channels: int,
                   nb: int):
    """Encode one pixel window from a carried state.

    raw_u8: (nb * channels,) uint8 raw pixels (padding arbitrary); n_px:
    pixels in the window, 1..nb; prev_c, run_c (0..61): () int32; seen_c:
    (64,) int32.  Returns (bytes (out_cap,) uint8, length () int32,
    prev_out, run_out, seen_out)."""
    packed = pixels_to_packed(raw_u8, channels).reshape(1, nb)
    out, lens, _, run_out, seen_out = encode_rows(
        packed, n_px, channels,
        carry=(prev_c.reshape(1), run_c.reshape(1), seen_c.reshape(64, 1)))
    last = n_px - 1
    return (out[0], lens[0], packed[0, last], run_out[0, last // BLK],
            seen_out[:, 0])


def lane_carries(packed, n_px: int, prev_c, run_c, seen_c):
    """The state entering each of L sub-windows (rows of packed (L, n)
    int32) of a window of n_px pixels, in closed form: (v (L,) valid
    pixels, prev_in (L,), run_in (L,), seen_in (64, L)), int32.  prev is
    the previous lane's last slot (lanes with pixels follow only full
    lanes); run and table fold the lanes' summaries (lane_summaries,
    fold_summaries)."""
    lanes, n = packed.shape
    lane = torch.arange(lanes, dtype=torch.int32, device=packed.device)
    v = (n_px - lane * n).clamp(0, n).to(torch.int32)
    prev_in = torch.cat([prev_c.reshape(1), packed[:-1, -1]])
    run_in, seen_in = fold_summaries(lane_summaries(packed, v, prev_in),
                                     run_c, seen_c)
    return v, prev_in, run_in, seen_in


def lane_summaries(packed, v, prev_in):
    """What the lanes after each row of pixel words need of it, given the
    pixel before it: packed (L, n), v (L,) valid pixels, prev_in (L,)
    int32.  Returns (L, 131) int32: v; the last pixel that
    differs from the one before it, + 1 (0: every pixel repeats it); the
    trailing streak of repeats; for each of the 64 table slots the last
    differing pixel of that hash, + 1 (0: none); then those pixels'
    words."""
    n = packed.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=packed.device)[None, :]
    prev_rows = torch.cat([prev_in[:, None], packed[:, :-1]], dim=1)
    pos1 = torch.where((idx < v[:, None]) & (packed != prev_rows), idx + 1, 0)
    brk = pos1.amax(dim=1)
    tail = (v - brk).clamp(min=0)
    jb = torch.zeros((packed.shape[0], 64), dtype=torch.int32,
                     device=packed.device)
    jb = jb.scatter_reduce(1, hash6(packed).to(torch.int64), pos1, "amax")
    vals = torch.gather(packed, 1, (jb - 1).clamp(min=0).to(torch.int64))
    return torch.cat([v[:, None], brk[:, None], tail[:, None], jb, vals],
                     dim=1)


def fold_summaries(summ, run_c, seen_c):
    """The run counter (L,) and the table (64, L) int32 entering each of L
    consecutive lanes, from their lane_summaries (L, 131) and
    the state entering the first, run_c () and seen_c (64,):

    - run: lane l leaves (run_l + v_l) % 62 if all its pixels repeat the
      one before, else its trailing streak % 62; unrolled, the run after
      lane l is (t_j + v_(j+1) + ... + v_l) % 62 for the last such broken
      lane j <= l (t_j its trailing streak), or (run_c + v_0 + ... + v_l)
      % 62 if there is none: one cummax and one cumsum;
    - table: slot s enters lane l holding the last differing pixel of hash
      s in the lanes before l, else seen_c[s]: a cummax over the lanes."""
    lanes = summ.shape[0]
    dev = summ.device
    lane = torch.arange(lanes, dtype=torch.int32, device=dev)
    v, brk, tail = summ[:, 0], summ[:, 1], summ[:, 2]
    jb, vals = summ[:, 3:67], summ[:, 67:]
    broken = torch.cummax(torch.where(brk > 0, lane, -1), dim=0).values
    csum = torch.cumsum(v, dim=0)
    at = broken.clamp(min=0).to(torch.int64)
    since = torch.where(broken >= 0, tail[at] - csum[at], run_c)
    run_after = (since + csum) % 62
    run_in = torch.cat([run_c.reshape(1), run_after[:-1]]).to(torch.int32)

    upto = torch.cummax(torch.where(jb > 0, lane[:, None], -1), dim=0).values
    before = torch.cat([torch.full((1, 64), -1, dtype=upto.dtype, device=dev),
                        upto[:-1]])
    seen_in = torch.where(before >= 0, torch.gather(
        vals, 0, before.clamp(min=0).to(torch.int64)), seen_c[None, :])
    return run_in, seen_in.T.contiguous()


def _encode_window_lanes(raw_u8, n_px: int, prev_c, run_c, seen_c,
                         channels: int, nb: int, lanes: int):
    """Multi-lane window encode: the window's nb pixel slots split into
    ``lanes`` contiguous sub-windows of nb / lanes pixels (nb a multiple
    of lanes * 64) whose entering states come from lane_carries, then E1,
    K3 and K4 at batch width L.

    Returns (out (L, lane_out_cap) uint8, lens (L,) int32, prev_out,
    run_out, seen_out); the window's chunk bytes are
    concat(out[l][:lens[l]])."""
    packed_flat = pixels_to_packed(raw_u8, channels)
    packed = packed_flat.reshape(lanes, nb // lanes)
    with tracing.span("stream.carry"):
        v, prev_in, run_in, seen_in = lane_carries(packed, n_px, prev_c,
                                                   run_c, seen_c)
    out, lens, _, run_out, seen_out = encode_rows(
        packed, v, channels, carry=(prev_in, run_in, seen_in))
    last = n_px - 1
    n = packed.shape[1]
    return (out, lens, packed_flat[last],
            run_out[last // n, (last % n) // BLK], seen_out[:, -1])


class DeviceStreamEncoder:
    """Window-granular streaming QOI encoder with device-resident state.

    Feed whole-pixel windows; receive each window's chunk bytes.
    finalize() returns the pending RUN byte (if any) plus the end marker.
    split_lanes > 1 cuts each window into that many sub-windows with
    closed-form carries (_encode_window_lanes); 1 encodes each window as
    one row.

    device: where the windows encode; None means "cuda".
    """

    def __init__(self, window_px: int = 1 << 18, split_lanes: int = 1,
                 device=None):
        self.split_lanes = max(int(split_lanes), 1)
        self.window_px = window_px
        if self.split_lanes > 1:
            self.nb = _round_up(window_px, self.split_lanes * TILE)
        else:
            self.nb = pad_to_tile(window_px)
        self.device = resolve_device(device)
        self.reset()

    def is_initialized(self) -> bool:
        return self._desc is not None

    def initialize(self, desc: Desc) -> Result[bytes]:
        """Returns the 14-byte header."""
        if self._desc is not None:
            return Result.err(Error.ALREADY_INITIALIZED)
        bc = count_bytes(desc)
        if not bc:
            return Result.err(bc.error())
        self._desc = desc
        prev, run, seen = start_state(1, self.device)  # the table is zero
        self._prev, self._run, self._seen = prev[0], run[0], seen[:, 0]
        return Result.ok(write_header(desc))

    def encode_window(self, raw) -> Result[np.ndarray]:
        """Encode a whole-pixel raw window; returns its chunk bytes."""
        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        ch = int(self._desc.channels)
        if isinstance(raw, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(raw, np.uint8)
        raw = np.asarray(raw, np.uint8).reshape(-1)
        if raw.size % ch:
            return Result.err(Error.MISMATCHED_DESC)
        n = raw.size // ch
        out_parts = []
        buf = np.zeros(self.nb * ch, np.uint8)
        for s in range(0, n, self.window_px):
            cnt = min(self.window_px, n - s)
            buf[: cnt * ch] = raw[s * ch : (s + cnt) * ch]
            with tracing.span("host.upload"):  # a plain (pageable) copy
                tracing.count("h2d_bytes", buf.nbytes)
                tracing.count("h2d_pageable_bytes", buf.nbytes)
                raw_t = torch.from_numpy(buf).to(self.device)
            if self.split_lanes > 1:
                out, lens, *carry = _encode_window_lanes(
                    raw_t, cnt, self._prev, self._run, self._seen,
                    channels=ch, nb=self.nb, lanes=self.split_lanes)
            else:
                out, lens, *carry = _encode_window(
                    raw_t, cnt, self._prev, self._run, self._seen,
                    channels=ch, nb=self.nb)
                out, lens = out[None], lens.reshape(1)
            self._prev, self._run, self._seen = carry
            # ONE bulk fetch of the window's bytes, lanes in order
            col = torch.arange(out.shape[1], device=out.device)[None, :]
            with tracing.span("host.fetch"):
                part = out.masked_select(col < lens[:, None]).cpu().numpy()
            tracing.count("d2h_bytes", part.nbytes)
            tracing.count("host_syncs")
            tracing.count("stream_windows")
            out_parts.append(part)
        return Result.ok(_joined(out_parts))

    def has_run_count(self) -> bool:
        return self._run is not None and int(self._run) > 0

    def finalize(self) -> Result[bytes]:
        """Pending run byte (if any) + end marker; resets the state."""
        if self._desc is None:
            return Result.err(Error.NOT_INITIALIZED)
        run = int(self._run)
        tail = (bytes([0xC0 | (run - 1)]) if run > 0 else b"") + END_MARKER
        self.reset()
        return Result.ok(tail)

    def reset(self) -> None:
        self._desc = None
        self._prev = None
        self._run = None
        self._seen = None


# --------------------------------------------------------------------------
# Whole streams through the classes
# --------------------------------------------------------------------------


def stream_decode(blob, window_cap: int, feed: Optional[int] = None,
                  pixel_cap: Optional[int] = None, device=None):
    """Decode a whole QOI stream through DeviceStreamDecoder, its chunk
    bytes fed in pieces of ``feed`` bytes (default window_cap).  Returns
    (raw pixels as numpy uint8, the decoder, whose ``windows`` describe
    the session)."""
    blob = np.asarray(blob, np.uint8)
    dec = DeviceStreamDecoder(window_cap, pixel_cap, device=device)
    dec.initialize(blob[:14]).value()
    body = blob[14:-8]
    feed = feed or window_cap
    parts = [dec.decode_window(body[i : i + feed]).value()
             for i in range(0, body.size, feed)]
    return _joined(parts), dec


def stream_encode(raw, desc: Desc, window_px: int, split_lanes: int = 1,
                  device=None) -> bytes:
    """Encode raw pixels through DeviceStreamEncoder, one window_px-pixel
    window per call.  Returns the whole stream: header, windows, finalize."""
    raw = np.asarray(raw, np.uint8).reshape(-1)
    enc = DeviceStreamEncoder(window_px, split_lanes, device)
    parts = [enc.initialize(desc).value()]
    step = window_px * int(desc.channels)
    for i in range(0, raw.size, step):
        parts.append(enc.encode_window(raw[i : i + step]).value().tobytes())
    parts.append(enc.finalize().value())
    return b"".join(parts)
