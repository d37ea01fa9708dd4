"""Length-bucketed batch scheduler for mixed-density corpora of one
geometry.

The port of ``qoipp_tpu.models.scheduler``.  ``BatchPipeline`` makes every
lane pay the batch's longest stream (its replay depth qb) and its worst
encode caps, so one dense image can tax every lane of a mixed batch.
``BucketedCodec`` groups streams into geometric length buckets, runs each
bucket's batch at its own qb and reassembles the results in submission
order: on the host (``decode``) or into one tensor on the device
(``decode_to_device``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import Channels, Desc
from ..convert import resolve_device
from ..utils import tracing
from ..utils.transfer import fetch, upload
from .packed import _as_arrays
from .pipeline import BatchPipeline

# Batch-count pad grid: steps of at most 1.5x from 1, so a bucket's zero
# padding is at most half its images (a third below 17).
_B_GRID = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _pad_b(n: int) -> int:
    for g in _B_GRID:
        if n <= g:
            return g
    return -(-n // 256) * 256


class BucketedCodec:
    """Batched QOI codec with geometric length bucketing.

    desc: the images' shared geometry.
    growth: bucket boundary ratio (2.0: buckets of 16K, 32K, 64K, ...).
    min_len: the smallest bucket's stream capacity in bytes.
    device: where the batches run; None means "cuda".
    """

    def __init__(self, desc: Desc, growth: float = 2.0,
                 min_len: int = 1 << 14, device=None):
        if not growth > 1.2:
            raise ValueError(f"growth {growth} must exceed 1.2")
        self.desc = desc
        self.growth = growth
        self.min_len = min_len
        self.device = resolve_device(device)
        self._pipes: Dict[int, BatchPipeline] = {}

    def _bucket_len(self, max_len: int) -> int:
        cap = self.min_len
        while cap < max_len:
            cap = int(cap * self.growth)
        return cap

    def _pipe(self, bucket_len: int) -> BatchPipeline:
        pipe = self._pipes.get(bucket_len)
        if pipe is None:
            pipe = BatchPipeline(self.desc, max_stream_len=bucket_len,
                                 max_encode_len=bucket_len,
                                 device=self.device)
            self._pipes[bucket_len] = pipe
        return pipe

    def _group(self, sizes: Sequence[int]) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i, s in enumerate(sizes):
            groups.setdefault(self._bucket_len(int(s)), []).append(i)
        return groups

    # -- decode -----------------------------------------------------------

    def prepare(self, blobs: Sequence) -> List[Tuple[List[int], BatchPipeline,
                                                     object, object]]:
        """Host staging: group the streams into buckets, pack each group
        and upload it.  Returns [(indices, pipe, streams, sizes)].  Counts
        ``bucket_streams`` (the real streams), ``bucket_lanes`` (the padded
        batches), ``bucket_rows`` (the region bytes the buckets replay,
        lanes x qb) and ``bucket_stream_bytes`` (the real streams' bytes)."""
        arrs = _as_arrays(blobs)
        with tracing.span("host.route"):
            groups = self._group([a.size for a in arrs])
        out = []
        for bucket_len, idxs in groups.items():
            pipe = self._pipe(bucket_len)
            bp = _pad_b(len(idxs))
            group = [arrs[i] for i in idxs]
            # pad lanes with header-only streams (they decode start pixels)
            group += [group[0][:14]] * (bp - len(idxs))
            streams, sizes = pipe.pack_streams(group)
            out.append((idxs, pipe, upload(streams, self.device),
                        upload(sizes, self.device)))
            tracing.count("bucket_lanes", bp)
            tracing.count("bucket_rows", bp * pipe.qb)
        tracing.count("bucket_streams", len(arrs))
        tracing.count("bucket_stream_bytes", sum(a.size for a in arrs))
        return out

    def decode_prepared(self, plan) -> List[Tuple[List[int], object]]:
        """Decode every bucket of a prepare() plan; returns [(indices,
        (Bp, n_cap) int32 packed pixels on the device)]."""
        return [(idxs, pipe.decode_packed(streams, sizes))
                for idxs, pipe, streams, sizes in plan]

    def decode_to_device(self, blobs: Sequence,
                         target: Optional[Channels] = None) -> torch.Tensor:
        """QOI byte streams (the shared geometry, any lengths) -> (B, H, W,
        C) uint8 on the codec's device, submission order.  Each bucket's
        real images go into the one output by a device index copy; nothing
        is fetched and nothing waits on the device."""
        ch = int(target) if target is not None else int(self.desc.channels)
        out = torch.empty((len(blobs), self.desc.height, self.desc.width, ch),
                          dtype=torch.uint8, device=self.device)
        for idxs, pipe, streams, sizes in self.prepare(blobs):
            imgs = pipe.decode(streams, sizes, target)
            # the bucket's positions in the output: copied without a wait,
            # and not among the uploads of stream data
            index = torch.tensor(idxs, dtype=torch.int64)
            if self.device.type == "cuda":
                index = index.pin_memory().to(self.device, non_blocking=True)
            with tracing.span("decode.assemble"):
                out.index_copy_(0, index, imgs[: len(idxs)])
        return out

    def decode(self, blobs: Sequence, target: Optional[Channels] = None
               ) -> np.ndarray:
        """QOI byte streams (the shared geometry, any lengths) -> (B, H, W,
        C) uint8 on the host, submission order: ``decode_to_device`` and
        one fetch."""
        (out,) = fetch(self.decode_to_device(blobs, target))
        return out

    # -- encode -----------------------------------------------------------

    def encode(self, raws, size_hints: Optional[Sequence[int]] = None
               ) -> List[np.ndarray]:
        """(B, ...) uint8 raw images -> QOI streams, submission order.

        size_hints: expected stream sizes, one an image; images bucket by
        hint.  Without hints every image takes the worst-size bucket.  An
        image whose stream overflows its bucket is encoded again in the
        next bucket up."""
        raws = np.asarray(raws, np.uint8).reshape(len(raws), -1)
        b = raws.shape[0]
        ch = int(self.desc.channels)
        worst = (ch + 1) * self.desc.width * self.desc.height + 22
        hints = ([int(h) for h in size_hints] if size_hints is not None
                 else [worst] * b)
        out: List[Optional[np.ndarray]] = [None] * b
        pending = list(range(b))
        while pending:
            groups = self._group([min(hints[i], worst) for i in pending])
            next_pending: List[int] = []
            for bucket_len, gi in groups.items():
                idxs = [pending[i] for i in gi]
                pipe = self._pipe(bucket_len)
                batch = np.zeros((_pad_b(len(idxs)), raws.shape[1]), np.uint8)
                batch[: len(idxs)] = raws[idxs]
                streams, lengths, ok = pipe.encode_raw_checked(
                    upload(batch, self.device))
                # the lengths first (small), then only the used bytes
                lengths, okh = fetch(lengths, ok)
                used = int(lengths[: len(idxs)].max(initial=1))
                (streams,) = fetch(streams[:, : -(-used // 128) * 128])
                for j, i in enumerate(idxs):
                    if okh[j]:
                        out[i] = streams[j, : lengths[j]].copy()
                    else:  # overflowed the bucket: the next one up
                        hints[i] = int(bucket_len * self.growth)
                        next_pending.append(i)
            pending = next_pending
        return out  # type: ignore[return-value]
