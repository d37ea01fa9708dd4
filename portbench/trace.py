"""The traced run's records: host spans, and the device trace of
torch.profiler reduced to intervals, kernel names, busy and idle time.

The interval arithmetic is ``qoipp_tpu_torch.utils.profile``'s
``busy_us`` (the union of device intervals), copied; the idle share is
taken over the traced window's wall time (the first traced call's start
to the last one's end), not over the first to last device event.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

SPAN_PREFIX = "portbench:"
# the program's own spans as profiler ranges (qoipp_tpu_torch.utils.tracing)
PROGRAM_PREFIX = "qoipp:"

# the program's own kernels (qoipp_tpu_torch/csrc), by function name
PORT_KERNELS = (
    "replay_kernel", "place_fill_kernel", "compact_kernel", "emit_kernel",
    "logfill_kernel", "fields_kernel", "fields_summary_kernel",
    "place_wide_kernel", "place_fill2_kernel", "place_grouped_kernel",
    "place_narrow_kernel", "place_variant_kernel", "emit_window_kernel",
    "grid_step_kernel", "onehot_place_kernel", "dep_chain_kernel")
_PORT_RE = re.compile(r"(?:^|[\s:])(" + "|".join(PORT_KERNELS)
                      + r")\s*[<(]")


class Event(NamedTuple):
    name: str
    start: float  # seconds, the profiler's clock
    end: float


class Span(NamedTuple):
    name: str
    call: int  # index of the call in the window, -1 outside it
    start: float  # seconds, time.perf_counter
    end: float


def port_kernel(name: str) -> Optional[str]:
    """The function name of one of the program's kernels, else None."""
    m = _PORT_RE.search(name)
    return m.group(1) if m else None


def is_transfer(name: str) -> bool:
    """A copy or fill the runtime issues (not a kernel)."""
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def short_name(name: str, limit: int = 96) -> str:
    """A device op's name without its return type and arguments."""
    if is_transfer(name):
        return name.strip()[:limit]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:limit]


class Recorder:
    """Host spans of the window's calls (always), mirrored as
    torch.profiler ranges while a trace is on."""

    def __init__(self):
        self.spans: List[Span] = []
        self.call = -1
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(Span(name, self.call, t, time.perf_counter()))
            if self.profiling:
                rf.__exit__(None, None, None)


class DeviceTrace(NamedTuple):
    """One traced stretch of calls: the device events and the spans in
    the profiler's clock, the window [lo, hi], the calls in it."""
    device: List[Event]
    spans: List[Event]
    lo: float
    hi: float
    calls: int

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union(clip([(e.start, e.end) for e in self.device],
                          self.lo, self.hi))


def read_profile(prof, calls: int) -> DeviceTrace:
    """A finished torch.profiler.profile -> DeviceTrace.  The window runs
    from the first traced call's span start to the last one's end."""
    from torch.autograd import DeviceType

    device, spans = [], []
    try:
        events = prof.profiler.kineto_results.events()
        rows = ((e.name(), e.device_type(), e.start_ns() * 1e-9,
                 (e.start_ns() + e.duration_ns()) * 1e-9) for e in events)
    except AttributeError:  # an older profiler: the slower event list
        rows = ((e.name, e.device_type, e.time_range.start * 1e-6,
                 e.time_range.end * 1e-6) for e in prof.events())
    for name, dtype, start, end in rows:
        if name.startswith(SPAN_PREFIX):
            # a span is also mirrored on the device's timeline as a user
            # annotation: the host's copy is the span, neither is work
            if dtype != DeviceType.CUDA:
                spans.append(Event(name[len(SPAN_PREFIX):], start, end))
        elif dtype == DeviceType.CUDA and not name.startswith(
                PROGRAM_PREFIX):  # the program's spans, mirrored likewise
            device.append(Event(name, start, end))
    call_spans = [s for s in spans if s.name == "call"]
    if not call_spans:
        raise RuntimeError("the trace holds no call span")
    lo = min(s.start for s in call_spans)
    hi = max(s.end for s in call_spans)
    return DeviceTrace(device, spans, lo, hi, calls)


def breakdown(tr: DeviceTrace, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps of
    the traced window, each named by the benchmark span below the call
    that covers most of it ("call" where none does; seconds, over the
    traced calls)."""
    by_name: dict = {}
    for e in tr.device:
        k = short_name(e.name)
        by_name[k] = by_name.get(k, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    named = []
    for s, e in gaps([(d.start, d.end) for d in tr.device], tr.lo, tr.hi):
        over = [(min(e, sp.end) - max(s, sp.start), sp.name)
                for sp in tr.spans if sp.name != "call"
                and sp.start < e and sp.end > s]
        label = max(over)[1] if over else (
            "call" if any(sp.start < e and sp.end > s for sp in tr.spans)
            else "between calls")
        named.append((label, e - s))
    named.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in named[:top]]}
