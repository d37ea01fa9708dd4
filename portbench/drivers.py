"""What the drivers share.  A driver makes the cell's inputs from the
seed, builds the program's entry point, runs one timed call, and holds
what the timed calls produced against the reference once the window has
closed.

A traffic file names its driver by ``kind``: ``kinds/<kind>.py`` exports
``DRIVER``, a ``Driver`` subclass, found by name as a metric's reader is
(``Spec.driver``), so a new engine's cell is new files alone.  Everything
else about the traffic (batch, requests a call, caps, warm-up and traced
calls) is a parameter of the file.  The program under test,
``qoipp_tpu_torch``, is imported only in ``build``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from . import corpus as corpus_mod
from . import generator, reference


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


def make(spec, config, traffic, seed, device, control=False) -> Driver:
    """The driver of the traffic's ``kind`` (``kinds/<kind>.py``)."""
    return spec.driver(traffic["kind"])(spec, config, traffic, seed, device,
                                        control)
