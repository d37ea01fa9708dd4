"""Split-replay decode: a large stream's chunks spread across replay lanes.

The port of ``qoipp_tpu.models.split`` (``SplitDecoder``).  One stream's
replay is a sequential walk; this engine cuts each stream on chunk
boundaries into cost-balanced segments (the native walker,
``oracle.split_points``), replays all segments at once as the lanes of K5
from guessed in-states, and reconciles the seams by a fixpoint:

  * replay round: K5 replays every lane from its in-state guess and
    returns (emits, out-state, transfer summary); a summary bit of 0 means
    that state component passed through the lane untouched;
  * propagate: each lane's implied in-state is, component by component,
    the out-state of the last lane before it in its chain that wrote the
    component, or the decoder's initial state if none did (chain heads
    start from it);
  * converged when every implied in-state equals the guess.  Any fixpoint
    is the exact sequential result, by induction from each chain head;
    the rounds are bounded by the longest chain + 2.

Chunk compaction (K3) moves replay and placement from the byte domain to
the chunk domain once, outside the fixpoint, where the stream is sparse
enough to gain; K2 places the pixels.  The host planner is the JAX
package's, line for line, so both packages make the same plans.  The
streaming decoder's windows run the same fixpoint as one chain whose head
re-enters the carried state (``_decode_window_lanes``).  ``propagate``
and ``seam_fixpoint`` live in ``ops/decode``, which the scan engine and
the sequence-parallel decode share.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import oracle
from ..ops import boundary
from ..ops import compact_kernel as ck
from ..ops import decode as dec_ops
from ..ops import place_kernel
from ..ops.bitops import START_PIXEL_PACKED
from ..ops.decode import seam_fixpoint, true_init_row
from ..utils import tracing
from ..utils.transfer import upload
from ..utils.transport import stage_h2d
from .packed import (Part, _bucket_mult, _parse_streams, _round_up,
                     gather_streams)


def _compact_cap(max_chunks: int, qb: int) -> int:
    """Chunk-domain width for _compact_chunks, or 0 to stay in the byte
    domain: compaction costs about one sweep of the byte planes, so it is
    taken only where it cuts the replay depth by at least a quarter."""
    qc = _bucket_mult(max_chunks + ck.BLK + 128, 512)
    return qc if 4 * qc <= 3 * qb else 0


def _compact_chunks(meta, val, pix_before, keep, n_cap: int, qc: int):
    """(L, qb) byte-domain (meta, val, pix_before) -> their (L, qc) chunk
    rows (keep = the real chunk starts), by K3.  Rows past a lane's count
    become NOP rows with pb = n_cap, which K2 never writes."""
    (meta_c, val_c, pb_c), counts = ck.compact_rows((meta, val, pix_before),
                                                    keep, qc)
    valid = (torch.arange(qc, device=keep.device)[None, :]
             < counts[:, None])
    return (torch.where(valid, meta_c, 0), torch.where(valid, val_c, 0),
            torch.where(valid, pb_c, n_cap))


def initial_guess(lanes: int, device):
    """The round-0 in-state of every lane: the initial state, except that
    empty table slots guess alpha 0xFF (a zero alpha taken from a guessed
    slot could never heal inside an RGB stream, where OP_RGB keeps the
    carried alpha)."""
    base = true_init_row(device)
    guess = torch.where(base == 0, START_PIXEL_PACKED, base)
    guess = guess[:, None].expand(65, lanes).contiguous()
    return guess[:1].contiguous(), guess[1:].contiguous()


def lane_fields(regions, chunks_sizes, px_budgets, qb: int):
    """The byte-domain stages: (L, qb + 8) uint8 segment bytes -> (meta,
    val, pix_before) (L, qb) int32 and real (L, qb) bool, the chunk
    starts (K3's keep where the chunk domain is taken)."""
    info = boundary.analyze_region_batch(regions[:, :qb], chunks_sizes, 0)
    real = info["real"]
    # clamp at the walker's per-segment pixel span, which stops RUN
    # production at w * h as the reference decoder does
    pix_before = torch.minimum(info["pix_before"], px_budgets[:, None])
    meta, val = dec_ops.fields_dense_batch(regions, real)
    return meta, val, pix_before, real


def lane_rows(regions, chunks_sizes, px_budgets, qb: int, n_cap: int,
              qc: int = 0):
    """The stages before the fixpoint: (L, qb + 8) uint8 segment bytes ->
    (meta, val) rows (width, L) int32 for K5, lane-major (views of the
    (L, width) planes), and (L, width) int32 pixel offsets for K2, width =
    qc or qb."""
    meta, val, pix_before, real = lane_fields(regions, chunks_sizes,
                                              px_budgets, qb)
    if qc:
        meta, val, pix_before = _compact_chunks(meta, val, pix_before, real,
                                                n_cap, qc)
    return meta.T, val.T, pix_before.contiguous()


def _decode_split_lanes(regions, heads, chunks_sizes, px_budgets,
                        max_chain: int, qb: int, n_cap: int, qc: int = 0):
    """regions: (L, qb + 8) uint8, one segment per lane, each opening on a
    chunk start; heads: (L,) bool, the lane starts a stream; chunks_sizes,
    px_budgets: (L,) int32, each segment's bytes and pixel span;
    max_chain: the longest chain; qc > 0 takes the chunk domain.

    Returns ((L, n_cap) int32 packed pixels per lane, rounds)."""
    meta_t, val_t, pix_before = lane_rows(regions, chunks_sizes, px_budgets,
                                          qb, n_cap, qc)
    emits, rounds, _ = seam_fixpoint(
        meta_t, val_t, heads, max_chain,
        initial_guess(meta_t.shape[1], meta_t.device))
    return (place_kernel.place_fill(pix_before, emits.T.contiguous(), n_cap),
            rounds)


def _decode_window_lanes(regions, seg_lens, prev0, seen_col0, max_chain: int,
                         qb: int, n_cap: int, qc: int = 0):
    """The streaming decoder's window: ONE chain over the lanes, whose head
    re-enters the carried state (prev0 (1,), seen_col0 (64,) int32), and
    lanes holding segments of a byte window whose last chunk may be torn.
    A chunk counts only if it ends inside its lane's seg_len (the driver
    feeds the torn tail again).  regions: (L, qb + 8) uint8, L a multiple
    of 8; seg_lens: (L,) int32; qc > 0 takes the chunk domain.

    Returns (packed (L, n_cap) int32, n_pix (L,), consumed (L,), prev_out
    (1,), seen_out (64,), rounds).  Zero-length lanes pass the state
    through, so the state after the last lane is the window's carry."""
    q = torch.arange(qb, dtype=torch.int32, device=regions.device)[None, :]
    body = regions[:, :qb]
    lens = boundary.chunk_len_of(body).to(torch.int32)
    complete = boundary.chunk_starts_batch(body) & (q + lens
                                                    <= seg_lens[:, None])
    tag = body.to(torch.int32)
    is_run = ((tag & 0xC0) == 0xC0) & (tag != 0xFE) & (tag != 0xFF)
    produced = torch.where(complete, torch.where(is_run, (tag & 0x3F) + 1, 1),
                           0)
    pix_before = torch.cumsum(produced, dim=1, dtype=torch.int32) - produced
    consumed = torch.where(complete, q + lens, 0).amax(dim=1)
    n_pix = produced.sum(dim=1, dtype=torch.int32)

    meta, val = dec_ops.fields_dense_batch(regions, complete)
    if qc:
        meta, val, pix_before = _compact_chunks(meta, val, pix_before,
                                                complete, n_cap, qc)
    heads = torch.zeros(regions.shape[0], dtype=torch.bool,
                        device=regions.device)
    heads[0] = True
    emits, rounds, fin = seam_fixpoint(
        meta.T, val.T, heads, max_chain,
        initial_guess(regions.shape[0], regions.device),
        torch.cat([prev0.reshape(1), seen_col0.reshape(64)]))
    packed = place_kernel.place_fill(pix_before.contiguous(),
                                     emits.T.contiguous(), n_cap)
    return packed, n_pix, consumed, fin[:1], fin[1:], rounds


def split_part(pixels, where, descs, idxs) -> Part:
    """A SplitDecoder result as a gather_streams part: stream idxs[k] is
    one run a lane, from the lane's first pixel to its place in the
    stream."""
    n_cap = pixels.shape[1]
    return pixels, [(i, d, [(lane * n_cap, p0, p1 - p0)
                            for lane, p0, p1 in segs])
                    for i, segs, d in zip(idxs, where, descs)]


class SplitDecoder:
    """Decode large QOI streams by splitting each across replay lanes.

    Each stream gets segments in proportion to its cost (bytes to replay
    and pixels to place), so the heaviest lane is as light as the set
    allows.  All segments of all streams ride one dispatch; chains never
    span dispatches.

    lanes: target lane count, 1..128.
    device: where the decode runs; None means "cuda".
    """

    MAX_LANES = 128

    def __init__(self, lanes: int = 128, device=None):
        if not 1 <= lanes <= self.MAX_LANES:
            raise ValueError("lanes must be in 1..128")
        self.lanes = lanes
        self.device = torch.device("cuda" if device is None else device)

    def decode(self, blobs: Sequence) -> List[np.ndarray]:
        """QOI streams -> their raw pixels (numpy uint8), one host fetch."""
        packed, where, descs, _ = self.decode_to_device(blobs)
        return self.gather(packed, where, descs)

    @staticmethod
    def gather(packed, where, descs) -> List[np.ndarray]:
        """decode_to_device's lanes -> each stream's raw pixels (numpy
        uint8), one fetch (gather_streams)."""
        return gather_streams([split_part(packed, where, descs,
                                          range(len(descs)))])

    def decode_to_device(self, blobs: Sequence):
        """Plan, upload and decode.  Returns ((L, n_cap) int32 pixels on
        the device, where [per stream: list of (lane, px_start, px_end)],
        descs, rounds)."""
        return self.dispatch_staged(self.stage_to_device(blobs))

    def stage_to_device(self, blobs: Sequence):
        """Plan and upload only; dispatch_staged decodes what it returns."""
        return self.stage_plan(self.plan_and_pack(blobs))

    def stage_plan(self, plan):
        """Upload a plan_and_pack host plan to the decoder's device (pinned
        memory, asynchronous copies; the regions through stage_h2d)."""
        (regions, heads, chunks_sizes, px_budgets, where, descs, qb, n_cap,
         max_chain, qc) = plan
        dev = self.device
        return (stage_h2d(regions, dev), upload(heads, dev),
                upload(chunks_sizes, dev), upload(px_budgets, dev),
                max_chain, where, descs, qb, n_cap, qc)

    def dispatch_staged(self, staged):
        """Decode a stage_to_device plan; returns (device pixels, where,
        descs, rounds), the pixels left on the device, and counts the
        fixpoint's rounds as ``split_rounds``."""
        (regions, heads, chunks_sizes, px_budgets, max_chain, where, descs,
         qb, n_cap, qc) = staged
        packed, rounds = _decode_split_lanes(
            regions, heads, chunks_sizes, px_budgets, max_chain, qb=qb,
            n_cap=n_cap, qc=qc)
        tracing.count("split_rounds", rounds)
        return packed, where, descs, rounds

    @tracing.traced("host.plan")
    def plan_and_pack(self, blobs: Sequence):
        """Host staging: native chunk-walk split per stream, one segment
        per lane.  Returns (regions (L, qb+8) u8, heads (L,) bool,
        chunks_sizes (L,) i32, px_budgets (L,) i32, where, descs, qb,
        n_cap, max_chain, qc: the chunk-domain width, 0 for the byte
        domain)."""
        arrs, descs = _parse_streams(blobs)
        sizes = [a.size - 22 for a in arrs]
        if any(s < 1 for s in sizes):
            raise ValueError("truncated stream (no body bytes)")
        pxs = [d.width * d.height for d in descs]

        # the JAX package's cost model: replay ~(46 + 2.45 L) per lane-depth
        # byte, place ~0.27 L per pixel-cap cell
        L = self.lanes
        byte_w = 46.0 + 2.45 * L
        px_w = 0.27 * L
        if len(arrs) > L:
            # every stream needs >= 1 lane
            raise ValueError(
                f"{len(arrs)} streams > {L} lanes; dispatch in groups of "
                "<= lanes streams"
            )
        costs = [byte_w * s + px_w * p for s, p in zip(sizes, pxs)]
        target = sum(costs) / L
        n_segs = [max(1, int(round(c / target))) for c in costs]
        while sum(n_segs) > L:  # rounding overshoot: trim the largest
            n_segs[int(np.argmax(n_segs))] -= 1
        assert all(k >= 1 for k in n_segs)  # guaranteed by len(arrs) <= L

        def _walk(chunk_w=0.0, bw=byte_w):
            plans = []  # (stream idx, byte offsets, px offsets, ordinals)
            for i, a in enumerate(arrs):
                # anchored cuts: segments open with an OP_RGB/OP_RGBA chunk
                # so the fixpoint converges in few rounds; the lookahead
                # bounds the balance skew
                lookahead = max(sizes[i] // max(n_segs[i], 1) // 4, 64)
                offs, poffs, cis = oracle.split_points(
                    a[14 : 14 + sizes[i]], pxs[i], n_segs[i], bw, px_w,
                    lookahead=lookahead,
                    prefer_rgba=int(descs[i].channels) == 4,
                    chunk_w=chunk_w,
                )
                plans.append((i, offs, poffs, cis))
            return plans

        def _caps(plans):
            seg_bytes = [
                int(offs[k + 1] - offs[k])
                for _, offs, _, _ in plans for k in range(len(offs) - 1)
            ]
            seg_px = [
                int(poffs[k + 1] - poffs[k])
                for _, _, poffs, _ in plans for k in range(len(poffs) - 1)
            ]
            seg_chunks = [
                int(cis[k + 1] - cis[k])
                for _, _, _, cis in plans for k in range(len(cis) - 1)
            ]
            gran = 8 * boundary.BLOCK
            qb = _bucket_mult(max(max(seg_bytes), gran), gran)
            n_cap = _bucket_mult(max(max(seg_px), 1), place_kernel.WIN)
            return len(seg_bytes), qb, n_cap, _compact_cap(max(seg_chunks),
                                                           qb)

        plans = _walk()
        n_lanes, qb, n_cap, qc = _caps(plans)

        l_ne = _round_up(n_lanes, 8)
        regions = np.zeros((l_ne, qb + 8), np.uint8)
        heads = np.zeros(l_ne, bool)
        heads[n_lanes:] = True  # padded lanes: their own chains
        chunks_sizes = np.zeros(l_ne, np.int32)
        px_budgets = np.zeros(l_ne, np.int32)
        where: List[List[Tuple[int, int, int]]] = [[] for _ in arrs]
        lane = 0
        max_chain = 1
        for i, offs, poffs, _ in plans:
            body = arrs[i][14 : 14 + sizes[i]]
            nseg = len(offs) - 1
            max_chain = max(max_chain, nseg)
            for k in range(nseg):
                b0, b1 = int(offs[k]), int(offs[k + 1])
                regions[lane, : b1 - b0] = body[b0:b1]
                chunks_sizes[lane] = b1 - b0
                px_budgets[lane] = int(poffs[k + 1]) - int(poffs[k])
                heads[lane] = k == 0
                where[i].append((lane, int(poffs[k]), int(poffs[k + 1])))
                lane += 1
        return (regions, heads, chunks_sizes, px_budgets, where, descs,
                qb, n_cap, max_chain, qc)
