"""One driver a kind of traffic: it makes the cell's inputs from the seed,
builds the program's entry point, runs one timed call, and holds what the
timed calls produced against the reference once the window has closed.

A traffic file names its driver by ``kind``; everything else about the
traffic (batch, requests a call, caps, warm-up and traced calls) is a
parameter of the file.  The program under test, ``qoipp_tpu_torch``, is
imported only in ``build``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import corpus as corpus_mod
from . import generator, reference, roofline


class Out(NamedTuple):
    """One timed call's result: what it produced, which inputs it served
    (an index list, or None for the whole batch), how many items (images
    or requests) and pixels."""
    outputs: object
    served: object
    items: int
    pixels: int


class Check(NamedTuple):
    """The numbers compared, each (value, limit), the outputs compared and
    how many of them were wrong."""
    numbers: dict
    compared: int
    wrong: int


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ref_encode(raw: np.ndarray, header, device, index_ops=True):
    return reference.encode(torch.from_numpy(raw).to(device), header,
                            index_ops=index_ops)


def _bytes_differ(got: np.ndarray, want: np.ndarray) -> int:
    """Bytes that differ, a length difference counting as differing
    bytes."""
    n = min(got.size, want.size)
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(
        int(got.size) - int(want.size))


class Driver:
    direction = ""  # "decode" or "encode": what the pixels count

    def __init__(self, spec, config, traffic, seed: int, device,
                 control: bool = False):
        self.spec, self.config, self.traffic = spec, config, traffic
        self.seed, self.device, self.control = seed, device, control
        self.work = {}  # roofline.Work a call, by kernel

    def prepare(self):
        """Inputs, and the reference work they need, before the program's
        memory is counted."""

    def build(self):
        """The program's entry point (and the control in its place)."""

    def warmup(self, rec):
        for _ in range(self.traffic.get("warmup_calls", 2)):
            self.call(rec)

    def call(self, rec) -> Out:
        raise NotImplementedError

    def release(self):
        """Drop the program's state before the reference runs."""

    def check(self, samples) -> Check:
        raise NotImplementedError


# -- uniform batches ---------------------------------------------------------

class _Batch(Driver):
    def prepare(self):
        c, t = self.config, self.traffic
        self.header = reference.Header(c["width"], c["height"],
                                       c["channels"], c.get("colorspace", 0))
        self.batch = t["batch"]
        self.n_px = c["width"] * c["height"]
        self.raws = generator.make_images(self.batch, c["width"],
                                          c["height"], self.seed,
                                          c["channels"])

    def _desc(self):
        from qoipp_tpu_torch.common import Channels, Colorspace, Desc
        h = self.header
        return Desc(h.width, h.height, Channels(h.channels),
                    Colorspace(h.colorspace))


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
        self.work = {
            "k3": roofline.k3_compact(self.batch * self.n_px, kept),
            "k4": roofline.k4_emit(kept + 3 * self.batch, nbytes)}
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


# -- serving over a corpus -----------------------------------------------------

class Draws:
    """Requests drawn uniformly over the corpus's files, in blocks of
    ``n_files`` calls in which each file is requested ``per_call`` times.
    Which requests share a call is dealt by ``deal_seed``, the traffic's,
    so every run serves the same calls; the run's seed shuffles the order
    of the calls in each block and of the requests in each call."""

    def __init__(self, seed: int, n_files: int, per_call: int, stream: int,
                 deal_seed: int = 0):
        self.deal = np.random.default_rng([deal_seed, stream])
        self.order = np.random.default_rng([seed, stream])
        self.n, self.k = n_files, per_call
        self.queue: List[List[int]] = []

    def next(self) -> List[int]:
        if not self.queue:
            block = self.deal.permutation(np.repeat(np.arange(self.n),
                                                    self.k))
            calls = [self.order.permutation(block[i: i + self.k]).tolist()
                     for i in range(0, block.size, self.k)]
            self.queue = [calls[i] for i in self.order.permutation(
                len(calls))]
        return self.queue.pop()


class _Serving(Driver):
    def prepare(self):
        self.corpus = corpus_mod.load(self.spec.root, self.config)
        self.per_call = self.traffic["requests_per_call"]
        n = len(self.corpus.names)
        deal = self.traffic.get("deal_seed", 0)
        self.draws = Draws(self.seed, n, self.per_call, 0, deal)
        self.warm = Draws(self.seed, n, self.per_call, 1, deal)
        self.px = [h.width * h.height for h in self.corpus.headers]

    def build(self):
        from qoipp_tpu_torch.models.serving import ServingCodec

        self.codec = ServingCodec(device=self.device)  # its defaults

    def warmup(self, rec):
        # every file once, so every route and bucket has been built, then
        # calls drawn as the window draws them
        self.call(rec, list(range(len(self.corpus.names))))
        for _ in range(self.traffic.get("warmup_calls", 2)):
            self.call(rec, self.warm.next())

    def release(self):
        self.codec = None

    def _reference_streams(self, raws):
        """The reference's stream of each file's pixels; raises unless it
        is the committed file byte for byte (then the pixels are the
        file's, whatever decoded them: encoding is one to one)."""
        want = []
        for raw, h, blob, name in zip(raws, self.corpus.headers,
                                      self.corpus.blobs, self.corpus.names):
            s = _ref_encode(raw, h, self.device).stream.cpu().numpy()
            if not np.array_equal(s, blob):
                raise RuntimeError(f"the reference's pixels of {name} do "
                                   "not encode to the committed file")
            want.append(s)
        return want


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


KINDS = {"batch_decode": BatchDecode, "batch_encode": BatchEncode,
         "serving_decode": ServingDecode, "serving_encode": ServingEncode}


def make(spec, config, traffic, seed, device, control=False) -> Driver:
    return KINDS[traffic["kind"]](spec, config, traffic, seed, device,
                                  control)
