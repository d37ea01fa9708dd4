"""The ``batch_decode`` kind: a uniform batch of host streams through
``BatchPipeline.decode``."""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline
from portbench.drivers import Check, Out, _Batch, _ref_encode, _sync


class BatchDecode(_Batch):
    """Each call packs the batch's host streams (``pack_streams``),
    decodes them with ``BatchPipeline.decode`` into (B, H, W, C) uint8 on
    the device, and synchronises."""
    direction = "decode"

    def prepare(self):
        super().prepare()
        self.blobs, ops = [], 0
        for raw in self.raws:
            enc = _ref_encode(raw, self.header, self.device)
            self.blobs.append(enc.stream.cpu().numpy())
            ops += enc.ops
        _sync(self.device)
        self.work = {
            "k1": roofline.k1_replay(ops, self.batch),
            "k2": roofline.k2_place(ops, self.batch * self.n_px)}

    def build(self):
        from qoipp_tpu_torch.common import Channels
        from qoipp_tpu_torch.models.pipeline import BatchPipeline

        # as an ingest pipeline builds it: the longest stream it holds
        self.pipe = BatchPipeline(
            self._desc(), max_stream_len=max(b.size for b in self.blobs),
            device=self.device)
        self.target = Channels(self.header.channels)
        if self.control:  # lossy: every channel's low bit dropped
            h = self.header
            self.control_out = torch.from_numpy(np.stack(self.raws)).to(
                self.device).bitwise_and_(0xFE).reshape(
                self.batch, h.height, h.width, h.channels)

    def call(self, rec) -> Out:
        if self.control:
            out = self.control_out
        else:
            with rec.span("pack_streams"):
                streams, sizes = self.pipe.pack_streams(self.blobs)
            with rec.span("decode"):
                out = self.pipe.decode(streams, sizes, self.target)
        with rec.span("sync"):
            _sync(self.device)
        return Out(out, None, self.batch, self.batch * self.n_px)

    def release(self):
        self.pipe = None
        self.control_out = None

    def check(self, samples) -> Check:
        wrong_bytes = wrong = compared = 0
        ch = int(self.target)
        for s in samples:
            out = s.outputs
            for i, raw in enumerate(self.raws):
                want = torch.from_numpy(raw).to(out.device).reshape(
                    self.n_px, self.header.channels)[:, :ch]
                got = out[i].reshape(-1, out.shape[-1])
                if got.shape != want.shape:
                    bad = want.numel()
                else:
                    bad = int((got != want).sum())
                wrong_bytes += bad
                wrong += bad > 0
                compared += 1
        return Check({"wrong_images": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = BatchDecode
