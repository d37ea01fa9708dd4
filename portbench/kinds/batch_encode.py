"""The ``batch_encode`` kind: a uniform batch of resident images through
``BatchPipeline.encode_packed_chunked``."""

from __future__ import annotations

import numpy as np
import torch

from portbench import roofline
from portbench.drivers import Check, Out, _Batch, _bytes_differ, _ref_encode


class BatchEncode(_Batch):
    """The batch sits on the device as (B, n_px * C) uint8 from set-up;
    each call runs ``raw_to_packed``, ``encode_packed_chunked(sub)`` and
    fetches the lengths, the ok flags and the streams' bytes up to the
    longest to the host."""
    direction = "encode"

    def prepare(self):
        super().prepare()
        self.raws_dev = torch.from_numpy(np.stack(self.raws)).to(
            self.device)
        self.work = {"e1": roofline.e1_fields(self.batch * self.n_px)}

    def build(self):
        from qoipp_tpu_torch.models.pipeline import BatchPipeline

        # the default caps (worst size), as a caller who does not know the
        # streams' sizes builds it
        self.pipe = BatchPipeline(self._desc(), device=self.device)
        self.sub = self.traffic.get("sub", self.batch)
        if self.control:  # valid streams, but not the reference's bytes
            self.control_out = [
                _ref_encode(r, self.header, self.device,
                            index_ops=False).stream.cpu().numpy()
                for r in self.raws]

    def call(self, rec) -> Out:
        if self.control:
            outs, ok = self.control_out, np.ones(self.batch, bool)
        else:
            with rec.span("raw_to_packed"):
                packed = self.pipe.raw_to_packed(self.raws_dev)
            with rec.span("encode"):
                streams, lengths, ok = self.pipe.encode_packed_chunked(
                    packed, self.sub)
            with rec.span("fetch"):
                lengths = lengths.cpu().numpy()
                ok = ok.cpu().numpy()
                host = streams[:, : int(lengths.max())].cpu().numpy()
            outs = [host[i, : lengths[i]] for i in range(self.batch)]
        return Out((outs, ok), None, self.batch, self.batch * self.n_px)

    def release(self):
        self.pipe = None

    def check(self, samples) -> Check:
        want, ops, kept, nbytes = [], 0, 0, 0
        for raw in self.raws:
            enc = _ref_encode(raw, self.header, self.device)
            want.append(enc.stream.cpu().numpy())
            ops += enc.ops
            kept += enc.kept
            nbytes += enc.stream.numel()
        self.work.update(
            k3=roofline.k3_compact(self.batch * self.n_px, kept),
            k4=roofline.k4_emit(kept + 3 * self.batch, nbytes))
        wrong_bytes = wrong = compared = 0
        for s in samples:
            # a stream the program flags as over its cap is compared as
            # it came: at the default (worst-size) caps none is
            outs, _ok = s.outputs
            for got, w in zip(outs, want):
                bad = _bytes_differ(got, w)
                wrong_bytes += bad
                wrong += bad > 0
                compared += 1
        return Check({"wrong_streams": (wrong, 0),
                      "wrong_bytes": (wrong_bytes, 0)}, compared, wrong)


DRIVER = BatchEncode
