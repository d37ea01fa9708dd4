"""The port's spans and counters: where a call's host time and device
work go, step by step.

Tracing is off unless a caller turns it on::

    from qoipp_tpu_torch.utils import tracing

    with tracing.collect() as tr:
        with tracing.request(7):
            codec.decode(blobs)
    tr.spans      # Span(name, id, parent, request, thread, start_ns, end_ns)
    tr.counters   # {(request, name): total}

``collect()`` is the only switch.  Off, ``span`` is one module-global
check that returns a shared no-op context (no allocation, no clock read)
and ``count`` returns at once.  On, a span takes its parent from its own
thread's stack, so a worker thread's spans start their own tree; it reads
``time.perf_counter_ns`` on entry and exit; and while a torch profiler
runs it also enters ``torch.profiler.record_function("qoipp:" + name)``,
so the step sits on the profiler's clock beside the device work it
launched (``utils/timing.trace`` writes both into one Chrome trace).

``request(rid)`` stamps ``rid`` on every span and counter increment inside
it, on every thread, so the spans of one call share an identifier; outside
any request they carry -1.  One request is open at a time in a process.

Span names say which step of which layer ran: ``host.*`` (packing,
routing, planning, uploads, fetches, blocking reads of a device flag,
host reassembly), ``decode.*`` and ``encode.*`` (the device steps).
Spans mark steps, never items: a loop over requests or rows gets one span
around it.  Counters: ``h2d_bytes``, ``h2d_pageable_bytes``,
``d2h_bytes``, ``host_syncs``, ``split_rounds``, ``packed_recodes``,
``template_rows``, ``fields_rows``, ``boundary_scans`` and
``boundary_scan_bytes`` (the chunk-start scan's launches and the region
bytes they read), ``gather_px`` (the pixels the decodes' gather wrote,
``ops/gather_kernel``), and the length buckets' ``bucket_streams``,
``bucket_lanes``, ``bucket_rows`` and ``bucket_stream_bytes``
(``models/scheduler.BucketedCodec.prepare``: the real streams, the padded
lanes, the region bytes the lanes replay, the real streams' bytes), and
``pack_pinned_bytes`` (the bytes ``BatchPipeline.pack_streams`` wrote into
pinned blocks, on a card), ``pack_px`` and ``pack_bytes`` (the pixels
``BatchPipeline.raw_to_packed`` packs into words and the raw bytes it
reads), and ``unpack_px`` and ``unpack_bytes`` (the pixels a batch decode
unpacks from words, padded lanes included, and the bytes it writes, the
target's channels a pixel).
``decode.assemble`` is the bucketed decode's index copy of each bucket's
images into its one output; ``encode.pack`` is ``raw_to_packed``'s
packing and its pad to the encoder's tile, and ``decode.unpack`` the
batch decode's unpacking of words into pixels.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PROFILER_PREFIX = "qoipp:"

_trace: Optional["Trace"] = None  # None: tracing is off
_request = -1
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


class Span(NamedTuple):
    name: str
    id: int
    parent: int  # -1 at the root of its thread
    request: int  # -1 outside any request
    thread: int  # threading.get_ident()
    start_ns: int  # time.perf_counter_ns
    end_ns: int


class Trace:
    """What one ``collect()`` recorded: the spans closed while it was on,
    in the order they closed, and the counters by (request, name)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[Tuple[int, str], int] = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _On:
    __slots__ = ("name", "id", "parent", "start", "range", "trace")

    def __init__(self, name: str, trace: Trace):
        self.name = name
        self.trace = trace

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else -1
        self.id = next(_ids)
        st.append(self.id)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _stack().pop()
        s = Span(self.name, self.id, self.parent, _request,
                 threading.get_ident(), self.start, end)
        with _lock:
            self.trace.spans.append(s)
        return False


def span(name: str):
    """A context manager that records the step ``name`` while tracing is
    on, and does nothing otherwise."""
    tr = _trace
    if tr is None:
        return _OFF
    return _On(name, tr)


def traced(name: str):
    """Decorator: the whole call is the span ``name``.  The function keeps
    its name and module attribute, so callers that replace it by attribute
    (chip_smoke's samplers) wrap the traced function."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _trace is None:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open request, while tracing
    is on."""
    tr = _trace
    if tr is None:
        return
    key = (_request, name)
    with _lock:
        tr.counters[key] = tr.counters.get(key, 0) + int(n)


class collect:
    """Turn tracing on for the body and yield its ``Trace``; off again on
    exit.  Not reentrant: one collection at a time in a process."""

    def __enter__(self) -> Trace:
        global _trace
        with _lock:
            if _trace is not None:
                raise RuntimeError("tracing is already collecting")
            _trace = Trace()
        return _trace

    def __exit__(self, *exc):
        global _trace
        with _lock:
            _trace = None
        return False


class request:
    """Stamp ``rid`` on every span and counter increment inside the body,
    on every thread; the previous request is restored on exit."""

    def __init__(self, rid: int):
        self.rid = int(rid)

    def __enter__(self):
        global _request
        self.prev, _request = _request, self.rid
        return None

    def __exit__(self, *exc):
        global _request
        _request = self.prev
        return False


def enabled() -> bool:
    """Whether a ``collect()`` is open."""
    return _trace is not None
