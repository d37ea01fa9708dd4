"""The ``stream_decode`` kind: one whole-image session a call through
``DeviceStreamDecoder`` at its defaults, fed the stream's chunk bytes in
pieces of the traffic's ``feed_bytes``."""

from __future__ import annotations

import numpy as np

from portbench import mosaic, roofline
from portbench.drivers import (Check, Driver, Out, _bytes_differ,
                               _ref_encode, _sync)


class StreamDecode(Driver):
    """The images are the traffic's ``images`` mosaics of the
    configuration, drawn from the seed, their streams the reference's, on
    the host from set-up; the calls take them in turn.  Each call is one
    session: ``initialize`` on the stream's 14-byte header,
    ``decode_window`` on each piece of its chunk bytes (no header, no end
    marker), ``reset``.  The windows' numpy pixels are kept as they came,
    not joined.

    Where the walker's cuts and the pieces' torn chunks fall differs from
    image to image, and with it the windows a session takes (64-76 for
    one 8K mosaic): taking the images in turn keeps a run's rate from
    following one draw."""
    direction = "decode"

    def prepare(self):
        self.header, self.raws = mosaic.from_config(
            self.spec.root, self.config, self.seed,
            self.traffic.get("images", 1))
        self.n_px = self.header.width * self.header.height
        feed = self.traffic["feed_bytes"]
        self.blobs, self.pieces, ops = [], [], 0
        for raw in self.raws:
            enc = _ref_encode(raw, self.header, self.device)
            blob = enc.stream.cpu().numpy()
            body = blob[14:-8]
            self.blobs.append(blob)
            self.pieces.append([body[i: i + feed]
                                for i in range(0, body.size, feed)])
            ops += enc.ops
        _sync(self.device)
        ops /= len(self.raws)  # a call's, on average
        # K5: one replay's worth of the real chunks (the lanes' state, the
        # program's choice, left out), whatever the rounds; K2: the pixels
        self.work = {
            "k5": roofline.Work(12 * ops, roofline.REPLAY_OPS_PER_CHUNK * ops),
            "k2": roofline.k2_place(ops, self.n_px)}
        self.calls = 0

    def build(self):
        from qoipp_tpu_torch.ops.device_stream import DeviceStreamDecoder

        self.dec = DeviceStreamDecoder(device=self.device)  # its defaults
        if self.control:  # lossy: every channel's low bit dropped
            self.control_out = [r & 0xFE for r in self.raws]

    def call(self, rec) -> Out:
        i = self.calls % len(self.raws)
        self.calls += 1
        if self.control:
            parts = [self.control_out[i]]
        else:
            self.dec.initialize(self.blobs[i][:14]).value()
            parts = [self.dec.decode_window(p).value()
                     for p in self.pieces[i]]
            self.dec.reset()
        return Out(parts, i, 1, self.n_px)

    def release(self):
        self.dec = None
        self.control_out = None

    def check(self, samples) -> Check:
        wrong_bytes = wrong = compared = 0
        for s in samples:
            got = (np.concatenate(s.outputs) if s.outputs
                   else np.zeros(0, np.uint8))
            bad = _bytes_differ(got, self.raws[s.served])
            wrong_bytes += bad
            wrong += bad > 0
            compared += 1
        return Check({"wrong_images": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = StreamDecode
