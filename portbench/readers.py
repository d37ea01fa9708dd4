"""Arithmetic the metric readers (``metrics/<name>.py``) share: host
spans a call, the device trace split into the program's kernels, copies
and the torch passes, and the idle share of the traced window."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .trace import is_transfer, port_kernel, union, clip


def span_ms(rec, name: str) -> Optional[float]:
    """Mean host-clock ms of the span ``name`` over the window's calls
    (a traced run traces its calls after the window)."""
    d = [s.end - s.start for s in rec.spans if s.name == name and s.call >= 0]
    return 1e3 * float(np.mean(d)) if d else None


def _torch_passes(rec):
    """Device events of the traced calls that are neither the program's
    own kernels nor copies or fills."""
    return [e for e in rec.trace.device
            if not port_kernel(e.name) and not is_transfer(e.name)]


def torch_passes_ms(rec, direction: str) -> Optional[float]:
    if rec.trace is None or rec.direction != direction:
        return None
    ev = _torch_passes(rec)
    return 1e3 * sum(e.end - e.start for e in ev) / rec.trace.calls


def launches_per_call(rec, direction: str) -> Optional[float]:
    if rec.trace is None or rec.direction != direction:
        return None
    return len(_torch_passes(rec)) / rec.trace.calls


def idle_pct(rec, direction: str) -> Optional[float]:
    """Percent of the traced window's wall time with no kernel, copy or
    fill running on the device."""
    tr = rec.trace
    if tr is None or rec.direction != direction or tr.window_s <= 0:
        return None
    busy = union(clip([(e.start, e.end) for e in tr.device], tr.lo, tr.hi))
    return 100.0 * (1.0 - busy / tr.window_s)


def mpix_s(rec, direction: str) -> Optional[float]:
    """Pixels of every call of the window over the window's time."""
    if rec.direction != direction or rec.window_s <= 0:
        return None
    return rec.pixels / rec.window_s / 1e6


def p95_ms(rec) -> Optional[float]:
    """The 95th percentile of every call's latency in the window (linear
    interpolation between order statistics), ms."""
    if not rec.latencies:
        return None
    return 1e3 * float(np.percentile(rec.latencies, 95))
