"""The ``serving_decode`` kind: calls of corpus requests through
``ServingCodec``'s staged decode."""

from __future__ import annotations

import numpy as np

from portbench import corpus as corpus_mod
from portbench.drivers import Check, Out, _Serving, _bytes_differ


class ServingDecode(_Serving):
    """Each call is ``ServingCodec`` decode of the call's requests, as
    ``decode_stage``, ``decode_dispatch_staged`` and ``decode_finish``:
    numpy pixels on the host, submission order."""
    direction = "decode"

    def build(self):
        super().build()
        if self.control:  # lossy: every channel's low bit dropped
            self.control_out = [r & 0xFE for r in corpus_mod.raw_pixels(
                self.spec.root, self.corpus)]

    def call(self, rec, idxs=None) -> Out:
        idxs = self.draws.next() if idxs is None else idxs
        if self.control:
            outs = [self.control_out[i] for i in idxs]
        else:
            blobs = [self.corpus.blobs[i] for i in idxs]
            with rec.span("decode_stage"):
                staged = self.codec.decode_stage(blobs)
            with rec.span("decode_dispatch_staged"):
                disp = self.codec.decode_dispatch_staged(staged)
            with rec.span("decode_finish"):
                outs = self.codec.decode_finish(disp)
        return Out(outs, idxs, len(idxs), sum(self.px[i] for i in idxs))

    def check(self, samples) -> Check:
        raws = corpus_mod.raw_pixels(self.spec.root, self.corpus)
        self._reference_streams(raws)
        wrong_bytes = wrong = compared = 0
        for s in samples:
            for i, got in zip(s.served, s.outputs):
                bad = _bytes_differ(np.asarray(got).reshape(-1), raws[i])
                wrong_bytes += bad
                wrong += bad > 0
                compared += 1
        return Check({"wrong_requests": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = ServingDecode
