"""The ``serving_encode`` kind: calls of corpus requests' raw pixels
through ``ServingCodec``'s staged encode."""

from __future__ import annotations

import numpy as np

from portbench import corpus as corpus_mod
from portbench.drivers import Check, Out, _Serving, _bytes_differ, _ref_encode


class ServingEncode(_Serving):
    """Each call is ``ServingCodec`` encode of the call's requests' raw
    pixels, as ``encode_stage``, ``encode_dispatch_staged`` and
    ``encode_finish``: complete streams on the host, submission order."""
    direction = "encode"

    def prepare(self):
        super().prepare()
        self.raws = corpus_mod.raw_pixels(self.spec.root, self.corpus)

    def build(self):
        from qoipp_tpu_torch.common import Channels, Colorspace, Desc

        super().build()
        self.descs = [Desc(h.width, h.height, Channels(h.channels),
                           Colorspace(h.colorspace))
                      for h in self.corpus.headers]
        if self.control:  # valid streams, but not the reference's bytes
            self.control_out = [
                _ref_encode(r, h, self.device, index_ops=False)
                .stream.cpu().numpy()
                for r, h in zip(self.raws, self.corpus.headers)]

    def call(self, rec, idxs=None) -> Out:
        idxs = self.draws.next() if idxs is None else idxs
        if self.control:
            outs = [self.control_out[i] for i in idxs]
        else:
            raws = [self.raws[i] for i in idxs]
            descs = [self.descs[i] for i in idxs]
            with rec.span("encode_stage"):
                staged = self.codec.encode_stage(raws, descs)
            with rec.span("encode_dispatch_staged"):
                disp = self.codec.encode_dispatch_staged(staged)
            with rec.span("encode_finish"):
                outs = self.codec.encode_finish(disp)
        return Out(outs, idxs, len(idxs), sum(self.px[i] for i in idxs))

    def check(self, samples) -> Check:
        want = self._reference_streams(self.raws)
        wrong_bytes = wrong = compared = 0
        for s in samples:
            for i, got in zip(s.served, s.outputs):
                bad = _bytes_differ(np.asarray(got).reshape(-1), want[i])
                wrong_bytes += bad
                wrong += bad > 0
                compared += 1
        return Check({"wrong_requests": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = ServingEncode
