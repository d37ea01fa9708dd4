"""The ``bucketed_decode`` kind: a batch of host streams of one geometry
and mixed density through ``BucketedCodec.decode_to_device``, into one
tensor on the device."""

from __future__ import annotations

import numpy as np
import torch

from portbench import generator, mosaic, roofline
from portbench.drivers import Check, Driver, Out, _ref_encode, _sync


def photo_positions(seed: int, batch: int, photos: int) -> np.ndarray:
    """The batch positions that hold photos, ascending: the first
    ``photos`` of ``numpy.random.default_rng([seed, 11]).permutation(batch)``."""
    return np.sort(np.random.default_rng([seed, 11]).permutation(batch)
                   [:photos])


class BucketedDecode(Driver):
    """The batch is the configuration's mix: ``photo_share`` of the
    traffic's ``batch`` frames are mosaics of its one tile file
    (``mosaic.from_config``, the i-th photo the i-th mosaic) at
    ``photo_positions``; the others are the generator's frames, in order.
    The reference encodes every frame in set-up; the streams stay on the
    host.  Each call is ``BucketedCodec(desc)`` (its defaults)
    ``.decode_to_device(blobs, target)`` into (B, H, W, C) uint8 on the
    device, then a synchronise."""
    direction = "decode"

    def prepare(self):
        c = self.config
        self.batch = self.traffic["batch"]
        photos = round(self.batch * c["photo_share"])
        self.header, tiles = mosaic.from_config(self.spec.root, c, self.seed,
                                                photos)
        h = self.header
        self.n_px = h.width * h.height
        self.photos = photo_positions(self.seed, self.batch, photos)
        flat = iter(generator.make_images(self.batch - photos, h.width,
                                          h.height, self.seed, h.channels))
        tiles = iter(tiles)
        is_photo = np.isin(np.arange(self.batch), self.photos)
        self.raws = [next(tiles) if p else next(flat) for p in is_photo]
        self.blobs, ops = [], 0
        for raw in self.raws:
            enc = _ref_encode(raw, h, self.device)
            self.blobs.append(enc.stream.cpu().numpy())
            ops += enc.ops
        _sync(self.device)
        # from the streams' real chunks and pixels, not the padded buckets
        self.work = {
            "k1": roofline.k1_replay(ops, self.batch),
            "k2": roofline.k2_place(ops, self.batch * self.n_px)}

    def build(self):
        from qoipp_tpu_torch.common import Channels, Colorspace, Desc
        from qoipp_tpu_torch.models.scheduler import BucketedCodec

        h = self.header
        codec = BucketedCodec(Desc(h.width, h.height, Channels(h.channels),
                                   Colorspace(h.colorspace)),
                              device=self.device)  # its defaults
        self.decode = codec.decode_to_device
        self.target = Channels(h.channels)
        if self.control:  # lossy: every channel's low bit dropped
            self.control_out = torch.from_numpy(np.stack(self.raws)).to(
                self.device).bitwise_and_(0xFE).reshape(
                self.batch, h.height, h.width, h.channels)

    def call(self, rec) -> Out:
        if self.control:
            out = self.control_out
        else:
            with rec.span("decode"):
                out = self.decode(self.blobs, self.target)
        with rec.span("sync"):
            _sync(self.device)
        return Out(out, None, self.batch, self.batch * self.n_px)

    def release(self):
        self.decode = None
        self.control_out = None

    def check(self, samples) -> Check:
        wrong_bytes = wrong = compared = 0
        for s in samples:
            out = s.outputs
            for i, raw in enumerate(self.raws):
                want = torch.from_numpy(raw).to(out.device)
                got = out[i].reshape(-1) if i < out.shape[0] else None
                if got is None or got.shape != want.shape:
                    bad = want.numel()
                else:
                    bad = int((got != want).sum())
                wrong_bytes += bad
                wrong += bad > 0
                compared += 1
        return Check({"wrong_images": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = BucketedDecode
