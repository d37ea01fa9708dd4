"""The ``stream_encode`` kind: one whole-image session a call through
``DeviceStreamEncoder`` at its defaults, fed the raw pixels in slices of
the traffic's ``slice_px`` pixels."""

from __future__ import annotations

import numpy as np

from portbench import mosaic, roofline
from portbench.drivers import (Check, Driver, Out, _bytes_differ,
                               _ref_encode, _sync)


class StreamEncode(Driver):
    """The image is the configuration's mosaic, its raw pixels on the host
    as a producer hands them over.  Each call is one session:
    ``initialize`` (the header), ``encode_window`` on each slice, then
    ``finalize`` (a pending run and the end marker).  The parts are kept
    as they came, not joined."""
    direction = "encode"

    def prepare(self):
        self.header, (self.raw,) = mosaic.from_config(
            self.spec.root, self.config, self.seed)
        self.n_px = self.header.width * self.header.height
        self.want = _ref_encode(self.raw, self.header,
                                self.device).stream.cpu().numpy()
        _sync(self.device)
        step = self.traffic["slice_px"] * self.header.channels
        self.slices = [self.raw[i: i + step]
                       for i in range(0, self.raw.size, step)]
        self.work = {"e1": roofline.e1_fields(self.n_px)}

    def build(self):
        from qoipp_tpu_torch.common import Channels, Colorspace, Desc
        from qoipp_tpu_torch.ops.device_stream import DeviceStreamEncoder

        h = self.header
        self.desc = Desc(h.width, h.height, Channels(h.channels),
                         Colorspace(h.colorspace))
        self.enc = DeviceStreamEncoder(device=self.device)  # its defaults
        if self.control:  # a valid stream, but not the reference's bytes
            self.control_out = [_ref_encode(
                self.raw, h, self.device, index_ops=False).stream.cpu()
                .numpy()]

    def call(self, rec) -> Out:
        if self.control:
            parts = self.control_out
        else:
            parts = [self.enc.initialize(self.desc).value()]
            parts += [self.enc.encode_window(s).value() for s in self.slices]
            parts.append(self.enc.finalize().value())
        return Out(parts, None, 1, self.n_px)

    def release(self):
        self.enc = None
        self.control_out = None

    def check(self, samples) -> Check:
        wrong_bytes = wrong = compared = 0
        for s in samples:
            got = np.frombuffer(b"".join(
                p if isinstance(p, bytes) else np.asarray(p).tobytes()
                for p in s.outputs), np.uint8)
            bad = _bytes_differ(got, self.want)
            wrong_bytes += bad
            wrong += bad > 0
            compared += 1
        return Check({"wrong_streams": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = StreamEncode
