"""Stream-packed lanes: many whole QOI streams per decode or encode lane,
so the device's work tracks the sum of the streams' sizes, not the batch
size times the largest.

The port of ``qoipp_tpu.models.packed``:

* decode (``PackedDecoder``): whole streams lie back to back in each
  replay lane.  Complete streams end on a chunk boundary, so the boundary
  pass runs unchanged over the concatenated bytes; a stream's first chunk
  carries a reset (meta bit 9) that makes K1 re-enter the decoder's start
  state; pixel offsets assigned contiguously along a lane are the boundary
  pass's prefix sum, so K2 places them unchanged (every stream's first
  pixel is written by its first chunk, so no run leaks across streams).
* encode (``PackedEncoder``): raw images lie back to back in each pixel
  lane with two tail slots after each, which carry its trailing run and
  end marker through K3 (``ops/encode.encode_lanes_checked``); K4 emits
  every stream of a lane in one call.

The planners are the JAX package's, line for line, cost models, lane
ladders and caps included, so both packages make the same plans.  Those
cost models and ladders were fitted on a TPU; they are kept for plan
parity, and refitting them on the card is later work.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import Desc, read_header, write_header
from ..convert import resolve_device
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops import encode as enc_ops
from ..ops import gather_kernel, place_kernel
from ..ops import replay_kernel as rk
from ..ops.compact_kernel import BLK as CBLK
from ..ops.emit_kernel import WIN as EMIT_WIN
from ..utils import tracing
from ..utils.transfer import fetch, fetch_pinned, read_flag, upload
from ..utils.transport import stage_h2d


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


def _pack_pixels_np(raw: np.ndarray, channels: int) -> np.ndarray:
    """(N * channels,) uint8 -> (N,) uint32 words r|g<<8|b<<16|a<<24 (RGB:
    a = 255)."""
    px = raw.reshape(-1, channels).astype(np.uint32)
    word = px[:, 0] | (px[:, 1] << 8) | (px[:, 2] << 16)
    if channels == 4:
        return word | (px[:, 3] << 24)
    return word | np.uint32(0xFF000000)


def _as_arrays(blobs: Sequence) -> List[np.ndarray]:
    """QOI streams (bytes-like or arrays) as uint8 numpy arrays."""
    return [np.frombuffer(bytes(x), np.uint8)
            if not isinstance(x, np.ndarray) else np.asarray(x, np.uint8)
            for x in blobs]


def _parse_streams(blobs: Sequence) -> Tuple[List[np.ndarray], List[Desc]]:
    """QOI streams -> (their uint8 arrays, their headers' Descs); raises
    ValueError on a stream whose header does not parse."""
    arrs = _as_arrays(blobs)
    descs = []
    for a in arrs:
        h = read_header(a)
        if not h:
            raise ValueError(f"bad stream: {h.error()}")
        descs.append(h.value())
    return arrs, descs


def plan_lanes(items: Sequence[Tuple[int, int]], lane_bytes: int
               ) -> List[List[int]]:
    """First-fit-decreasing bin packing of (bytes, px) items into lanes of
    lane_bytes chunk-byte capacity.  Returns lists of item indices."""
    order = sorted(range(len(items)), key=lambda i: -items[i][0])
    lanes: List[List[int]] = []
    loads: List[int] = []
    for i in order:
        sz = items[i][0]
        for L, load in enumerate(loads):
            if load + sz <= lane_bytes:
                lanes[L].append(i)
                loads[L] += sz
                break
        else:
            lanes.append([i])
            loads.append(sz)
    return lanes


def plan_lanes_balanced(slots: Sequence[int], n_lanes: int, lane_cap: int,
                        weights: Optional[Sequence[float]] = None
                        ) -> List[List[int]]:
    """LPT (longest-processing-time) assignment of streams to n_lanes
    lanes of lane_cap slots: descending by weight (default: the slot
    count), each onto the least-weighted lane with room.  Every lane pays
    the worst lane's caps, so an even spread minimises the total work.
    Raises ValueError where lane_cap is too small for the set."""
    w = list(weights) if weights is not None else list(slots)
    order = sorted(range(len(slots)), key=lambda i: -w[i])
    lanes: List[List[int]] = [[] for _ in range(n_lanes)]
    loads = [0] * n_lanes
    wloads = [0.0] * n_lanes
    for i in order:
        cands = sorted(range(n_lanes), key=lambda L: wloads[L])
        for L in cands:
            if loads[L] + slots[i] <= lane_cap:
                lanes[L].append(i)
                loads[L] += slots[i]
                wloads[L] += w[i]
                break
        else:
            raise ValueError("lane_cap too small for the stream set")
    return lanes


def lane_inputs(regions, seg_flat, chunks_sizes, qb: int,
                l_total: Optional[int] = None):
    """The stages before the kernels: regions (L_ne, qb + 8) uint8, the
    nonempty lanes only (the rest of the l_total-lane grid is zero lanes
    added here, on the device); seg_flat (S,) int64 flat lane * qb + offset
    stream starts; chunks_sizes (l_total,) int32 each lane's bytes.
    Returns (meta, val) (qb, l_total) int32 rows for K1, lane-major (views
    of the (l_total, qb) planes), each stream's first chunk carrying the
    reset bit, and the (l_total, qb) int32 pixel offsets for K2."""
    l_ne = regions.shape[0]
    l_total = l_ne if l_total is None else l_total
    if l_total > l_ne:
        regions = torch.nn.functional.pad(regions, (0, 0, 0, l_total - l_ne))
    flags = torch.zeros(l_total * qb, dtype=torch.int32,
                        device=regions.device)
    flags[seg_flat] = 1
    info = boundary.analyze_region_batch(regions[:, :qb].contiguous(),
                                         chunks_sizes, 0)
    meta, val = dec_ops.fields_dense_batch(regions, info["real"])
    meta = meta | (flags.view(l_total, qb) << 9)  # stream resets
    return meta.T, val.T, info["pix_before"]


def _decode_lanes(regions, seg_flat, chunks_sizes, qb: int, n_cap: int,
                  l_total: Optional[int] = None):
    """lane_inputs, K1 and K2: (l_total, n_cap) int32 packed pixels, n_cap
    a multiple of place_kernel.WIN."""
    meta_t, val_t, pix_before = lane_inputs(regions, seg_flat, chunks_sizes,
                                            qb, l_total)
    # K1's emits come back in the rows' lane-major layout, so the
    # transpose back is a view
    emits = rk.replay_batch(meta_t, val_t).T.contiguous()
    return place_kernel.place_fill(pix_before, emits, n_cap)


# a gather_streams part: a decoder's (L, n_cap) int32 pixel words and its
# streams, each (output index, Desc, [(first word, first pixel, pixels)])
Part = Tuple[torch.Tensor, List[Tuple[int, Desc, List[Tuple[int, int, int]]]]]


def packed_part(pixels, where, descs, idxs) -> Part:
    """A PackedDecoder result as a gather_streams part: stream idxs[k] is
    one run of its lane from its pixel offset."""
    n_cap = pixels.shape[1]
    return pixels, [(i, d, [(Li * n_cap + poff, 0, d.width * d.height)])
                    for i, (Li, poff), d in zip(idxs, where, descs)]


@tracing.traced("host.unpack")
def gather_streams(parts: Sequence[Part]) -> List[np.ndarray]:
    """Decoded pixel words -> each stream's raw pixels ((w * h * channels,)
    uint8), in output order, which the parts' indices 0 .. n - 1 give.

    The streams' bytes lie back to back in one device buffer in output
    order: one segment table for all parts is uploaded, G1
    (ops/gather_kernel) writes each part's segments, and one pinned fetch
    brings the buffer over; each result is a slice of one fresh array."""
    descs = {i: d for _, ss in parts for i, d, _ in ss}
    if not descs:
        return []
    size = [descs[i].width * descs[i].height * int(descs[i].channels)
            for i in range(len(descs))]
    off = np.cumsum([0] + size)
    tables = [gather_kernel.segment_table(
        (w, n, int(off[i]) + p0 * int(d.channels), int(d.channels))
        for i, d, pieces in ss for w, p0, n in pieces) for _, ss in parts]
    dev = parts[0][0].device
    table_dev = upload(np.concatenate(tables), dev)
    out = torch.empty(int(off[-1]), dtype=torch.uint8, device=dev)
    r = 0
    for (pixels, _), table in zip(parts, tables):
        gather_kernel.gather_pixels(pixels, table, out,
                                    table_dev[r: r + len(table)])
        r += len(table)
    host = fetch_pinned(out)
    return [host[off[i]: off[i + 1]] for i in range(len(size))]


class PackedDecoder:
    """Decode mixed QOI streams (any geometry, RGB or RGBA) through packed
    replay lanes.

    Streams spread over up to MAX_LANES lanes balanced by a byte and pixel
    weight (LPT), and the lane depth qb is the smallest bucket that fits:
    the replay's sequential depth is the heaviest lane's bytes, so many
    short balanced lanes keep it low.

    lane_bytes: each stream's body-byte cap (larger streams route to the
        split engine, models/serving.py) and the depth granule.
    device: where the decode runs; None means "cuda".
    """

    MAX_LANES = 128  # the JAX package's lane cap, kept for plan parity

    def __init__(self, lane_bytes: int = 1 << 20, device=None):
        self.lane_bytes = _round_up(lane_bytes, boundary.BLOCK)
        self.device = resolve_device(device)

    def decode(self, blobs: Sequence) -> List[np.ndarray]:
        """QOI byte streams -> their raw pixels (each stream's channels),
        submission order, one fetch (gather_streams)."""
        packed, where, descs = self.decode_to_device(blobs)
        return gather_streams([packed_part(packed, where, descs,
                                           range(len(descs)))])

    def decode_to_device(self, blobs: Sequence):
        """Plan, upload and decode: returns ((l_total, n_cap) int32 pixels
        on the device, where [(lane, px_offset)], descs)."""
        return self.dispatch_staged(self.stage_to_device(blobs))

    def stage_to_device(self, blobs: Sequence):
        """Plan and upload only; dispatch_staged decodes what it returns."""
        return self.stage_plan(self.plan_and_pack(blobs))

    def stage_plan(self, plan):
        """Upload a plan_and_pack host plan to the decoder's device
        (pinned memory, asynchronous copies; the regions through
        stage_h2d)."""
        regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total = plan
        dev = self.device
        return (stage_h2d(regions, dev), upload(seg.astype(np.int64), dev),
                upload(chunks_sizes, dev), where, descs, qb, n_cap, l_total)

    @staticmethod
    def dispatch_staged(staged):
        """Decode a stage_to_device plan; returns (device pixels, where,
        descs), the pixels left on the device."""
        regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total = staged
        packed = _decode_lanes(regions, seg, chunks_sizes, qb=qb,
                               n_cap=n_cap, l_total=l_total)
        return packed, where, descs

    @tracing.traced("host.plan")
    def plan_and_pack(self, blobs: Sequence):
        """Host staging: plan balanced lanes and build the device inputs.
        Returns (regions (L_ne, qb + 8) uint8, the nonempty lanes only;
        seg (S,) int32 flat stream starts; chunks_sizes (l_total,) int32;
        where [(lane, px_offset)]; descs; qb; n_cap; l_total)."""
        arrs, descs = _parse_streams(blobs)
        items = [(a.size - 22, d.width * d.height)
                 for a, d in zip(arrs, descs)]
        for sz, _ in items:
            if sz > self.lane_bytes:
                raise ValueError(
                    f"stream of {sz} body bytes exceeds lane capacity "
                    f"{self.lane_bytes}; raise lane_bytes or route the "
                    "stream to the batched pipeline")
            if sz < 1:
                # a header with no body would repeat the previous stream
                # start, and a reset row would land on another stream
                raise ValueError(
                    f"stream of {sz} body bytes is truncated (total size "
                    "<= header + end marker); not a decodable stream")
        # The JAX package's lane-plan search and decode cost model, its
        # coefficients as fitted there: the replay is sequential in the
        # lane depth qb, the boundary and field passes and the upload sweep
        # every lane-grid cell, K2 sweeps lanes x pixel cap.  qb follows
        # the heaviest lane's bytes and n_cap its pixels, so the LPT
        # balances a combined weight.  Lane counts are multiples of 16.
        slots = [sz for sz, _ in items]
        pxs = [px for _, px in items]
        gran = 8 * boundary.BLOCK
        lmax = min(self.MAX_LANES, max(_round_up(len(items), 16), 16))
        best = None
        for L in (16, 32, 48, 64, 96, 128):
            if L > lmax:
                break
            wts = [(46 + 2.45 * L) * sz + 0.27 * L * px for sz, px in items]
            qb = _bucket_mult(
                max(-(-sum(slots) // L), max(slots, default=1), gran), gran)
            while True:
                try:
                    cand = plan_lanes_balanced(slots, L, qb, wts)
                    break
                except ValueError:
                    qb = _bucket_mult(qb + 1, gran)
            ncap = _bucket_mult(
                max((sum(pxs[i] for i in m) for m in cand if m), default=1),
                place_kernel.WIN)
            cost = (46 + 2.45 * L) * qb + 0.27 * L * ncap
            if best is None or cost < best[0]:
                best = (cost, cand, qb)
        _, lanes, qb = best
        # nonempty lanes first; only they are uploaded (a multiple of 8 of
        # them), and the device pads the grid to l_total, a multiple of 16
        lanes = [m for m in sorted(lanes, key=lambda m: -len(m)) if m]
        l_total = max(16, _round_up(max(len(lanes), 1), 16))
        l_ne = min(_round_up(max(len(lanes), 1), 8), l_total)

        regions = np.zeros((l_ne, qb + 8), np.uint8)
        seg_flat: List[int] = []
        chunks_sizes = np.zeros(l_total, np.int32)
        where: List[Tuple[int, int]] = [(0, 0)] * len(arrs)
        lane_px = np.zeros(l_ne, np.int64)
        for Li, members in enumerate(lanes):
            boff = 0
            poff = 0
            for i in members:
                sz, npx = items[i]
                regions[Li, boff: boff + sz] = arrs[i][14: 14 + sz]
                seg_flat.append(Li * qb + boff)
                where[i] = (Li, poff)
                boff += sz
                poff += npx
            chunks_sizes[Li] = boff
            lane_px[Li] = poff

        n_cap = _bucket_mult(max(int(lane_px.max()), 1), place_kernel.WIN)
        seg = np.asarray(seg_flat or [0], np.int32)
        return regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total


class PackedEncoder:
    """Encode mixed raw images (any geometry, RGB or RGBA) through packed
    pixel lanes, bit-exact with the reference encoder for every stream.

    Images spread over the lanes balanced by pixels and chunks (LPT); the
    lane size is the smallest bucket that fits.  The chunk cap is counted
    exactly at pack time; the byte cap starts at a fraction of the worst
    case, and finish() encodes again at the safe caps if a lane's checked
    flag trips.

    lane_px: each image's pixel-slot cap (larger images route to the
        bucketed batch engine, models/serving.py) and the least lane size.
    lanes: a lane count the plan search tries.
    out_frac: the first byte cap as a fraction of the safe bound.
    lane_counts: the lane counts the plan search tries (None: a default
        set).
    device: where the encode runs; None means "cuda".
    """

    def __init__(self, lane_px: int = 1 << 20, lanes: int = 8,
                 out_frac: float = 0.3,
                 lane_counts: Optional[Sequence[int]] = None, device=None):
        self.lane_px = _round_up(lane_px, 2048)
        self.lanes = lanes
        self.out_frac = out_frac
        self.lane_counts = lane_counts
        self.device = resolve_device(device)

    @tracing.traced("host.plan")
    def plan_and_pack(self, raws: Sequence[np.ndarray],
                      descs: Sequence[Desc]):
        """Host staging: plan balanced lanes and build the device inputs.
        Returns (packed (L, Np) uint32, flags (L, Np) uint8, where [(lane,
        order in lane)], caps dict)."""
        if len(raws) != len(descs):
            raise ValueError("raws and descs length mismatch")
        slots, px_arrays, stream_chunks = [], [], []
        for raw, d in zip(raws, descs):
            npx = d.width * d.height
            ch = int(d.channels)
            if np.asarray(raw).size != npx * ch:
                raise ValueError(
                    f"raw buffer size {np.asarray(raw).size} != {npx * ch}")
            if npx + 2 > self.lane_px:
                raise ValueError(
                    f"stream of {npx} px exceeds lane capacity "
                    f"{self.lane_px - 2}; raise lane_px or route the "
                    "stream to the batched pipeline")
            pk = _pack_pixels_np(np.asarray(raw, dtype=np.uint8), ch)
            px_arrays.append(pk)
            slots.append(npx + 2)
            # exact compacted rows of each stream, its 2 tail rows included
            stream_chunks.append(self._count_stream_chunks(pk) + 2)

        # The JAX package's plan search over lane counts and encode cost
        # model, its coefficients as fitted there: the dense pass and K3
        # scale with L x Np, the table scan and K4 with L x chunk_cap
        # (the worst lane's chunk count, so the LPT balances slots and
        # chunks).
        total = sum(slots)
        wts = [s + 1.2 * c for s, c in zip(slots, stream_chunks)]
        best = None
        cand_counts = (sorted(set(self.lane_counts)) if self.lane_counts
                       else sorted({self.lanes, 8, 10, 12, 16}))
        for n_lanes in cand_counts:
            np_ = _bucket_mult(
                max(-(-total // n_lanes), max(slots, default=1)), 2048)
            while True:
                try:
                    cand = plan_lanes_balanced(slots, n_lanes, np_, wts)
                    break
                except ValueError:
                    np_ = _bucket_mult(np_ + 1, 2048)
            cand = [m for m in cand if m]
            ccap = _bucket_mult(
                max((sum(stream_chunks[i] for i in m) for m in cand),
                    default=1) + CBLK + 256, 2048)
            cost = len(cand) * (np_ + 1.2 * ccap)
            if best is None or cost < best[0]:
                best = (cost, cand, np_, ccap)
        _, lanes, np_, chunk_cap_t = best

        L = len(lanes)
        packed = np.zeros((L, np_), np.uint32)
        flags = np.zeros((L, np_), np.uint8)
        where: List[Tuple[int, int]] = [(0, 0)] * len(raws)
        worst = np.zeros(L, np.int64)
        max_members = 1
        for Li, members in enumerate(lanes):
            off = 0
            for k, i in enumerate(members):
                d = descs[i]
                npx = d.width * d.height
                ch = int(d.channels)
                packed[Li, off: off + npx] = px_arrays[i]
                flags[Li, off] |= enc_ops.FLAG_SEG_START
                flags[Li, off: off + npx] |= enc_ops.FLAG_VALID
                flags[Li, off + npx] = enc_ops.FLAG_TAIL0
                flags[Li, off + npx + 1] = enc_ops.FLAG_TAIL1
                where[i] = (Li, k)
                off += npx + 2
                worst[Li] += (ch + 1) * npx + 9
            max_members = max(max_members, len(members))

        safe_chunk = _round_up(np_ + np_ // 62 + CBLK + 256, 2048)
        safe_out = _bucket_mult(max(int(worst.max()), 1), EMIT_WIN)
        max_count = max(chunk_cap_t - CBLK - 256, 1)
        caps = dict(
            chunk_cap=min(chunk_cap_t, safe_chunk),
            # ~3 bytes a chunk covers photo, DIFF and LUMA mixes; noise
            # trips the checked flag and encodes again at the safe bound
            out_cap=min(
                _bucket_mult(3 * max_count + 32, EMIT_WIN),
                _bucket_mult(int(self.out_frac * safe_out) + 1, EMIT_WIN),
                safe_out),
            ends_cap=_round_up(max_members + 2048 + 128, 128),
            safe_chunk=safe_chunk,
            safe_out=safe_out,
        )
        return packed, flags, where, caps

    @staticmethod
    def _count_stream_chunks(pk: np.ndarray) -> int:
        """One stream's compacted rows (its 2 tail rows not included):
        differing pixels plus RUN-62 flush points, the keep predicate of
        the lane encoder's dense pass, in numpy."""
        prev = np.empty_like(pk)
        prev[0] = np.uint32(0xFF000000)  # the start pixel
        prev[1:] = pk[:-1]
        eq = pk == prev
        n_noneq = int((~eq).sum())
        # a maximal streak of m equal pixels flushes floor(m / 62) RUN-62s
        e = eq.astype(np.int8)
        d = np.diff(np.concatenate([[0], e, [0]]))
        starts = np.nonzero(d == 1)[0]
        stops = np.nonzero(d == -1)[0]
        return n_noneq + int(((stops - starts) // 62).sum())

    def encode(self, raws: Sequence[np.ndarray],
               descs: Sequence[Desc]) -> List[np.ndarray]:
        """Raw pixel buffers and their Descs -> complete QOI streams
        (header and body), submission order."""
        return self.finish(self.dispatch_staged(
            self.stage_to_device(raws, descs)))

    def stage_to_device(self, raws: Sequence[np.ndarray],
                        descs: Sequence[Desc]):
        """Plan and upload only; dispatch_staged encodes what it returns."""
        return self.stage_plan(self.plan_and_pack(raws, descs) + (descs,))

    def stage_plan(self, plan):
        """Upload a plan_and_pack host plan (and its descs) to the
        encoder's device (pinned memory, asynchronous copies, through
        stage_h2d)."""
        packed, flags, where, caps, descs = plan
        return (stage_h2d(packed.view(np.int32), self.device),
                stage_h2d(flags, self.device), where, caps, descs)

    @staticmethod
    def dispatch_staged(staged):
        """Encode a staged plan; returns (out, ends, nseg, ok device
        tensors, staged, where, descs), the byte lanes left on the device.
        The checked flag is read in finish(), not here, so this call does
        not wait for the device."""
        packed_d, flags_d, where, caps, descs = staged
        out, ends, nseg, ok = enc_ops.encode_lanes_checked(
            packed_d, flags_d, chunk_cap=caps["chunk_cap"],
            out_cap=caps["out_cap"], ends_cap=caps["ends_cap"])
        return out, ends, nseg, ok, staged, where, descs

    @staticmethod
    def finish(dispatched) -> List[np.ndarray]:
        """Fetch and slice a dispatch_staged result into complete QOI
        streams, submission order; encodes again at the safe caps where a
        lane overflowed the first ones, which counts one
        ``packed_recodes``."""
        out, ends, nseg, ok, staged, where, descs = dispatched
        if not read_flag(ok.all()):
            tracing.count("packed_recodes")
            packed_d, flags_d, _, caps, _ = staged
            out, ends, nseg, ok = enc_ops.encode_lanes_checked(
                packed_d, flags_d, chunk_cap=caps["safe_chunk"],
                out_cap=caps["safe_out"], ends_cap=caps["ends_cap"])
            if not read_flag(ok.all()):
                raise AssertionError(
                    "packed encode overflowed the safe caps, which are "
                    "sized from the worst size and cannot overflow")
        # the ends first (small), then only each lane's used bytes
        ends, nseg_h = fetch(ends, nseg)
        used = max((int(ends[Li, nseg_h[Li] - 1])
                    for Li in range(ends.shape[0]) if nseg_h[Li] > 0),
                   default=1)
        (out,) = fetch(out[:, : _round_up(max(used, 1), 128)])
        results: List[np.ndarray] = []
        with tracing.span("host.unpack"):
            for i, d in enumerate(descs):
                Li, k = where[i]
                start = int(ends[Li, k - 1]) if k else 0
                stop = int(ends[Li, k])
                header = np.frombuffer(write_header(d), dtype=np.uint8)
                results.append(np.concatenate([header,
                                               out[Li, start:stop]]))
        return results
