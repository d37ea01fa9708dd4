"""Composite serving codec: one front end for mixed corpora.

The port of ``qoipp_tpu.models.serving``.  Each stream is routed to the
engine whose shape fits it:

* packed lanes (models/packed.py): small and mid streams, in size tiers,
  share replay and compaction lanes, so a tier's work tracks the sum of
  its sizes (K1, K2 to decode; K3, K4 to encode);
* split replay (models/split.py): streams above the pack cap are cut
  into segments spread over replay lanes and reconciled by the seam
  fixpoint (K5, K3, K2);
* length-bucketed batches (models/scheduler.py): images above the
  packed encoder's pixel cap, grouped by geometry (K3, K4).

Every route is bit-exact with the reference codec; the router only picks
shapes.  The tier constants are the JAX package's, fitted on a TPU and
kept so the routes equal its routes; refitting them on the card is later
work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import Desc
from ..convert import resolve_device
from ..utils import tracing
from ..utils.transfer import fetch, read_flag
from ..utils.transport import stage_h2d
from .packed import (PackedDecoder, PackedEncoder, _parse_streams,
                     gather_streams, packed_part)
from .scheduler import BucketedCodec, _pad_b
from .split import SplitDecoder, split_part


def _size_tiers(idxs: Sequence[int], size: Dict[int, int], span: int,
                min_streams: int) -> List[List[int]]:
    """Greedy size tiers: descending by size, a new tier where the next
    member is more than span times smaller than the tier's largest and
    the tier already holds min_streams members; a trailing tier of fewer
    than min_streams // 2 merges into the one before it."""
    order = sorted(idxs, key=lambda i: -size[i])
    tiers: List[List[int]] = []
    t0 = 0
    for i in order:
        if (tiers and size[i] * span >= t0) or (
                tiers and len(tiers[-1]) < min_streams):
            tiers[-1].append(i)
        else:
            tiers.append([i])
            t0 = size[i]
    if len(tiers) >= 2 and len(tiers[-1]) < min_streams // 2:
        tiers[-2].extend(tiers.pop())
    return tiers


class ResidentCorpus:
    """A decode corpus staged on the device once (ServingCodec.
    make_resident): decode_device() decodes it again from the staged
    inputs with no upload, decode() also fetches and reassembles."""

    def __init__(self, codec: "ServingCodec", staged):
        self._codec = codec
        self._staged = staged
        self.n_streams = staged[0]

    def decode_device(self):
        """Decode from the staged inputs; returns the decode_finish-ready
        plan, its pixels left on the device."""
        return self._codec.decode_dispatch_staged(self._staged)

    def decode(self) -> List[np.ndarray]:
        """decode_device, fetched and reassembled into raw pixel buffers,
        submission order."""
        return self._codec.decode_finish(self.decode_device())


class ServingCodec:
    """Mixed-corpus QOI codec over the packed, split and bucketed engines.

    Decode: streams of at most min(pack_lane_bytes, split_min_bytes) body
    bytes and DEC_PACK_PX_CAP pixels group into size tiers (at most
    DEC_TIER_SPAN apart in max(body bytes, pixels)), one packed decode a
    tier; the rest go to the split engine in groups of at most
    split_lanes.  Encode: images of at most pack_lane_px - 2 pixels tier
    the same way through the packed encoder; the rest group by geometry
    into the bucketed batch engine.

    pack_lane_bytes: a stream's body-byte cap for decode packing.
    pack_lane_px: the packed encoder's pixel-slot cap.
    growth / min_len: the bucketed engine's bucket geometry.
    split_min_bytes: bodies above it take the split engine.
    split_lanes: replay lanes a split decode.
    device: where every engine runs; None means "cuda".
    """

    DEC_TIER_SPAN = 4      # the largest size ratio inside one packed tier
    DEC_TIER_MIN = 16      # the fewest streams a tier
    DEC_PACK_PX_CAP = 1 << 24  # streams with more pixels take the split

    def __init__(self, pack_lane_bytes: int = 8 << 20,
                 pack_lane_px: int = 1 << 20,
                 growth: float = 2.0, min_len: int = 1 << 14,
                 split_min_bytes: int = 1 << 20,
                 split_lanes: int = 128, device=None):
        self.device = resolve_device(device)
        self._dec_pack = PackedDecoder(lane_bytes=pack_lane_bytes,
                                       device=self.device)
        self._enc_pack = PackedEncoder(lane_px=pack_lane_px,
                                       device=self.device)
        self._dec_split = SplitDecoder(lanes=split_lanes, device=self.device)
        self._split_min = split_min_bytes
        self._growth = growth
        self._min_len = min_len
        self._buckets: Dict[Tuple[int, int, int], BucketedCodec] = {}

    def _bucket(self, desc: Desc) -> BucketedCodec:
        key = (desc.width, desc.height, int(desc.channels))
        codec = self._buckets.get(key)
        if codec is None:
            codec = BucketedCodec(desc, growth=self._growth,
                                  min_len=self._min_len, device=self.device)
            self._buckets[key] = codec
        return codec

    # -- decode -------------------------------------------------------------

    def decode(self, blobs: Sequence) -> List[np.ndarray]:
        """QOI byte streams (any geometry, channels and length) -> their
        raw pixels (each stream's channels), submission order."""
        return self.decode_finish(self.decode_dispatch(blobs))

    @tracing.traced("host.route")
    def _decode_routes(self, blobs: Sequence):
        """(arrays, packed tiers, split groups) of a decode request."""
        arrs, descs = _parse_streams(blobs)
        packable = self._packable(arrs, descs)
        t = {i: max(arrs[i].size - 22, descs[i].width * descs[i].height)
             for i in packable}
        tiers = _size_tiers(packable, t, self.DEC_TIER_SPAN,
                            self.DEC_TIER_MIN)
        taken = set(packable)
        rest = [i for i in range(len(arrs)) if i not in taken]
        return arrs, tiers, self._split_groups(rest)

    def decode_dispatch(self, blobs: Sequence):
        """Plan, upload and decode on every engine, tier by tier; returns
        the decode_finish-ready plan (n, packed parts, split parts), the
        pixels left on the device.  Kernels are queued, not waited for."""
        arrs, tiers, groups = self._decode_routes(blobs)
        packed_parts = [
            (idxs, self._dec_pack.decode_to_device([arrs[i] for i in idxs]))
            for idxs in tiers]
        split_parts = [
            (grp, self._dec_split.decode_to_device([arrs[i] for i in grp]))
            for grp in groups]
        return len(arrs), packed_parts, split_parts

    def _packable(self, arrs, descs) -> List[int]:
        return [i for i in range(len(arrs))
                if arrs[i].size - 22
                <= min(self._dec_pack.lane_bytes, self._split_min)
                and descs[i].width * descs[i].height <= self.DEC_PACK_PX_CAP]

    def _split_groups(self, rest: List[int]) -> List[List[int]]:
        """Over-cap streams in groups of at most split_lanes (each stream
        needs a lane)."""
        cap = self._dec_split.lanes
        return [rest[i: i + cap] for i in range(0, len(rest), cap)]

    def decode_dispatch_overlapped(self, blobs: Sequence):
        """decode_dispatch with the host's planning pipelined against the
        uploads: the calling thread plans tier after tier while one worker
        thread uploads each planned tier and queues its decode.  On a card
        the worker uploads on a side stream, so a tier's copy overlaps the
        previous tier's kernels; the compute stream waits for the copy
        before it reads the inputs.  Returns decode_dispatch's plan."""
        from concurrent.futures import ThreadPoolExecutor

        arrs, tiers, groups = self._decode_routes(blobs)
        compute = side = None
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)

        def run(eng, plan):
            if side is None:
                return eng.dispatch_staged(eng.stage_plan(plan))
            with torch.cuda.stream(side):
                staged = eng.stage_plan(plan)
            compute.wait_stream(side)
            # the inputs were allocated on the side stream and are read on
            # the compute stream: keep their memory until it is done
            for x in staged:
                if isinstance(x, torch.Tensor):
                    x.record_stream(compute)
            with torch.cuda.stream(compute):
                return eng.dispatch_staged(staged)

        engines = ([(idxs, self._dec_pack) for idxs in tiers]
                   + [(grp, self._dec_split) for grp in groups])
        with ThreadPoolExecutor(1) as ex:
            # each tier is handed to the worker as soon as it is planned
            futs = [(idxs, ex.submit(run, eng, eng.plan_and_pack(
                [arrs[i] for i in idxs]))) for idxs, eng in engines]
            parts = [(idxs, f.result()) for idxs, f in futs]
        return len(arrs), parts[: len(tiers)], parts[len(tiers):]

    def decode_stage(self, blobs: Sequence):
        """Plan and upload every engine's inputs without decoding; pair
        with decode_dispatch_staged (the device's work alone)."""
        arrs, tiers, groups = self._decode_routes(blobs)
        packed_staged = [
            (idxs, self._dec_pack.stage_to_device([arrs[i] for i in idxs]))
            for idxs in tiers]
        split_staged = [
            (grp, self._dec_split.stage_to_device([arrs[i] for i in grp]))
            for grp in groups]
        return len(arrs), packed_staged, split_staged

    def make_resident(self, blobs: Sequence) -> "ResidentCorpus":
        """Stage a corpus's decode inputs on the device once and return a
        handle that decodes from them any number of times, no upload
        again."""
        return ResidentCorpus(self, self.decode_stage(blobs))

    def decode_dispatch_staged(self, staged):
        """Decode a decode_stage plan; returns the decode_finish-ready
        plan, the pixels left on the device."""
        n, packed_staged, split_staged = staged
        packed_parts = [(idxs, self._dec_pack.dispatch_staged(s))
                        for idxs, s in packed_staged]
        split_parts = [(idxs, self._dec_split.dispatch_staged(s))
                       for idxs, s in split_staged]
        return n, packed_parts, split_parts

    def decode_finish(self, dispatched) -> List[np.ndarray]:
        """A decode plan's device results -> each stream's raw pixels,
        submission order: every engine part's streams gathered on the
        device into one buffer, and one fetch (gather_streams)."""
        _, packed_parts, split_parts = dispatched
        # the rounds went into split_rounds where the route ran them
        return gather_streams(
            [packed_part(dev, where, descs, idxs)
             for idxs, (dev, where, descs) in packed_parts]
            + [split_part(dev, where, descs, idxs)
               for idxs, (dev, where, descs, _rounds) in split_parts])

    # -- encode -------------------------------------------------------------

    def encode(self, raws: Sequence[np.ndarray],
               descs: Sequence[Desc]) -> List[np.ndarray]:
        """Raw pixel buffers and their Descs (any geometry and channels) ->
        complete QOI streams, submission order."""
        return self.encode_finish(self.encode_dispatch(raws, descs))

    @tracing.traced("host.route")
    def _encode_plan(self, raws: Sequence[np.ndarray],
                     descs: Sequence[Desc]):
        """Host planning shared by the encode paths: the packable images in
        size tiers (pixels set every encode lane's cost), the rest grouped
        by geometry for the bucketed engine."""
        if len(raws) != len(descs):
            raise ValueError("raws and descs length mismatch")
        raws = [np.asarray(r, np.uint8).reshape(-1) for r in raws]
        packable = [i for i, d in enumerate(descs)
                    if d.width * d.height + 2 <= self._enc_pack.lane_px]
        t = {i: descs[i].width * descs[i].height for i in packable}
        tiers = _size_tiers(packable, t, self.DEC_TIER_SPAN,
                            self.DEC_TIER_MIN)
        taken = set(packable)
        by_geom: Dict[Tuple[int, int, int], List[int]] = {}
        for i in range(len(raws)):
            if i not in taken:
                d = descs[i]
                by_geom.setdefault((d.width, d.height, int(d.channels)),
                                   []).append(i)
        return raws, tiers, by_geom

    def encode_dispatch(self, raws: Sequence[np.ndarray],
                        descs: Sequence[Desc]):
        """Plan, upload and encode on every engine; the byte lanes stay on
        the device.  encode_finish() fetches and reassembles."""
        return self.encode_dispatch_staged(self.encode_stage(raws, descs))

    def encode_stage(self, raws: Sequence[np.ndarray],
                     descs: Sequence[Desc]):
        """Plan and upload every encode engine's inputs without encoding;
        pair with encode_dispatch_staged."""
        raws, tiers, by_geom = self._encode_plan(raws, descs)
        packed_staged = [
            (tier, self._enc_pack.stage_to_device(
                [raws[i] for i in tier], [descs[i] for i in tier]))
            for tier in tiers]
        bucket_staged = []
        for idxs in by_geom.values():
            d = descs[idxs[0]]
            codec = self._bucket(d)
            worst = (int(d.channels) + 1) * d.width * d.height + 22
            pipe = codec._pipe(codec._bucket_len(worst))
            with tracing.span("host.plan"):
                batch = np.zeros((_pad_b(len(idxs)), raws[idxs[0]].size),
                                 np.uint8)
                for j, i in enumerate(idxs):
                    batch[j] = raws[i]
            bucket_staged.append((idxs, pipe, stage_h2d(batch, self.device),
                                  d))
        return len(raws), packed_staged, bucket_staged

    def encode_dispatch_staged(self, staged):
        """Encode an encode_stage plan; returns the encode_finish-ready
        plan, the byte lanes left on the device."""
        n, packed_staged, bucket_staged = staged
        packed_parts = [(idxs, self._enc_pack.dispatch_staged(s))
                        for idxs, s in packed_staged]
        bucket_parts = []
        for idxs, pipe, batch_d, d in bucket_staged:
            streams, lengths, ok = pipe.encode_raw_checked(batch_d)
            bucket_parts.append((idxs, streams, lengths, ok, d))
        return n, packed_parts, bucket_parts

    def encode_finish(self, dispatched) -> List[np.ndarray]:
        """Fetch an encode plan's device results and reassemble complete
        QOI streams, submission order."""
        n, packed_parts, bucket_parts = dispatched
        results: List[Optional[np.ndarray]] = [None] * n
        for tier, disp in packed_parts:
            for i, stream in zip(tier, self._enc_pack.finish(disp)):
                results[i] = stream
        for idxs, streams, lengths, ok, d in bucket_parts:
            (lengths,) = fetch(lengths)
            # the bucket is the worst size, so a tripped flag is a fault
            if not read_flag(ok[: len(idxs)].all()):
                raise AssertionError(
                    "bucketed encode overflowed its worst-size bucket")
            used = int(lengths[: len(idxs)].max(initial=1))
            (host,) = fetch(streams[:, : min(streams.shape[1],
                                             -(-used // 8192) * 8192)])
            with tracing.span("host.unpack"):
                for j, i in enumerate(idxs):
                    results[i] = host[j, : lengths[j]].copy()
        return results  # type: ignore[return-value]
