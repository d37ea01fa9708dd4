"""A run of one cell with the program's own tracing on: the spans and
counters of ``qoipp_tpu_torch.utils.tracing`` read into per-layer
numbers, what tracing costs, and the device trace tied to the program's
steps.

    python -m portbench.program --workload <cell> --seed <n> \
        --seconds <s> [--windows 3]

The cell is set up as ``portbench.run`` sets it up (its driver, inputs
from the seed, warm-up).  Then ``2 x windows`` windows of ``--seconds``
alternate, tracing off then on, each call of an on window in a
``tracing.request`` of its own: the rates of the two kinds are the
tracing's cost end to end.  Then the cell's traced calls run under
torch.profiler with tracing on, so every span is also a ``qoipp:`` range
on the profiler's clock and each device op is tied, by the correlation
id kineto puts on it and on the host op that launched it, to the
innermost span open at that launch.  The outputs of the on windows and
of the traced calls are held against the reference as ``portbench.run``
holds its window's.

The last line of standard output is one JSON object: ``correct``,
``metrics`` (the readers of ``READERS`` that found something), the
rates, spans and counters a call, the cost of one span, and on a card
``breakdown``: ``idle_gaps_program``, ``idle_by_span``,
``device_ops_by_span``, the ops that took most device time inside
``decode.boundary`` and ``encode.templates``, and how each device op was
tied to its launch (``tied``); seconds over the traced calls.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
import traceback
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import drivers, guard
from .harness import (Sample, _power_limit, _profiler, _sync, kind_of,
                      require_device)
from .spec import Spec
from .trace import Recorder, gaps, is_transfer, read_profile, short_name

RANGE_PREFIX = "qoipp:"
OUTSIDE = "outside the program"


# -- the profile, tied to the program's spans ----------------------------------

class Range(NamedTuple):
    """A program span as the profiler saw it (seconds, its clock)."""
    name: str
    start: float
    end: float
    thread: int


class DeviceOp(NamedTuple):
    name: str
    start: float
    end: float
    spans: Tuple[str, ...]  # the spans open at its launch, outermost first


class ProgramProfile(NamedTuple):
    ranges: List[Range]
    device: List[DeviceOp]
    lo: float  # the traced window: first call's start to last call's end
    hi: float
    calls: int
    tied: Dict[str, int]  # device ops found through a runtime call, a
    # host op, or neither


RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


def _rows(prof):
    """(name, device type, start ns, end ns, correlation id, linked
    correlation id, thread, activity type or None) of every event kineto
    kept."""
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        yield (e.name(), e.device_type(), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.correlation_id(),
               e.linked_correlation_id(), e.start_thread_id(), kind)


def _open_at(ranges: List[Range], queries: List[Tuple[float, int]]):
    """For each (time, thread) query, the names of the ranges of its
    thread open at that time, outermost first.  A thread's ranges nest."""
    out: List[Tuple[str, ...]] = [()] * len(queries)
    by_thread: Dict[int, list] = {}
    for r in ranges:
        by_thread.setdefault(r.thread, []).append((r.start, 0, -r.end, r))
    for j, (t, th) in enumerate(queries):
        by_thread.setdefault(th, []).append((t, 1, 0, j))
    for events in by_thread.values():
        stack: List[Range] = []
        for t, kind, _, x in sorted(events, key=lambda e: e[:3]):
            # a range that starts as another ends follows it
            while stack and (stack[-1].end < t
                             or (kind == 0 and stack[-1].end <= t)):
                stack.pop()
            if kind == 0:
                stack.append(x)
            else:
                out[x] = tuple(r.name for r in stack)
    return out


def tie(rows, lo: float, hi: float, calls: int) -> ProgramProfile:
    """Rows as ``_rows`` gives them -> ProgramProfile.  A device op shares
    its correlation id with the runtime call that launched it (a kernel
    launch, a copy); the spans open on the launching thread at that call's
    start are the op's.  Where the trace kept no such call, the op's
    linked correlation id names the host op (a torch operator) that
    launched it, and that op's start is taken instead.  Runtime calls
    carry the runtime's thread ids: each is mapped to the thread of the
    torch ops its calls are linked to."""
    from torch.autograd import DeviceType

    ranges, ops, dev, calls_rt = [], {}, [], []
    for name, dtype, s, e, corr, linked, th, kind in rows:
        if dtype == DeviceType.CUDA:
            # the profiler mirrors ranges on the device's timeline as
            # annotations: they are not work
            if not name.startswith((RANGE_PREFIX, "portbench:")):
                dev.append((name, s * 1e-9, e * 1e-9, corr, linked))
        elif kind in RUNTIME_KINDS or (kind is None
                                       and name.startswith("cu")):
            calls_rt.append((corr, s * 1e-9, th, linked))
        elif linked == 0:
            ops[corr] = (s * 1e-9, th)
            if name.startswith(RANGE_PREFIX):
                ranges.append(Range(name[len(RANGE_PREFIX):], s * 1e-9,
                                    e * 1e-9, th))
    thread = {}
    for _, _, th, linked in calls_rt:
        if linked in ops:
            thread.setdefault(th, ops[linked][1])
    runtime = {corr: (s, thread.get(th, th))
               for corr, s, th, _ in calls_rt}
    queries, tied = [], {"runtime": 0, "op": 0, "neither": 0}
    for _, _, _, corr, linked in dev:
        if corr in runtime:
            queries.append(runtime[corr])
            tied["runtime"] += 1
        elif linked in ops:
            queries.append(ops[linked])
            tied["op"] += 1
        else:  # asks on no thread: no span holds it
            queries.append((0.0, -1))
            tied["neither"] += 1
    chains = _open_at(ranges, queries)
    device = [DeviceOp(n, s, e, c)
              for (n, s, e, _, _), c in zip(dev, chains)]
    return ProgramProfile(ranges, device, lo, hi, calls, tied)


def read_program_profile(prof, calls: int) -> ProgramProfile:
    """A finished torch.profiler.profile of ``calls`` benchmark calls (each
    a ``portbench:call`` range) -> ProgramProfile."""
    tr = read_profile(prof, calls)
    return tie(_rows(prof), tr.lo, tr.hi, calls)


def _innermost(ranges: List[Range]):
    """The window cut at every range boundary: (starts, ends, names), each
    piece named by the deepest range open over it on any thread (None
    where none is)."""
    depth: Dict[Range, int] = {}
    edges = sorted({r.start for r in ranges} | {r.end for r in ranges})
    # depth of each range: how many ranges of its thread hold it
    by_thread: Dict[int, List[Range]] = {}
    for r in ranges:
        by_thread.setdefault(r.thread, []).append(r)
    for rs in by_thread.values():
        stack: List[Range] = []
        for r in sorted(rs, key=lambda r: (r.start, -r.end)):
            while stack and stack[-1].end <= r.start:
                stack.pop()
            depth[r] = len(stack)
            stack.append(r)
    starts, ends, names = [], [], []
    order = sorted(ranges, key=lambda r: r.start)
    open_: List[Range] = []
    k = 0
    for a, b in zip(edges, edges[1:]):
        while k < len(order) and order[k].start <= a:
            open_.append(order[k])
            k += 1
        open_ = [r for r in open_ if r.end > a]
        best = max(open_, key=lambda r: (depth[r], r.start), default=None)
        starts.append(a)
        ends.append(b)
        names.append(best.name if best else None)
    return starts, ends, names


def idle_gaps_program(p: ProgramProfile, top: int = 10,
                      least: float = 1e-3):
    """The traced window's stretches with nothing on the device, each named
    by the innermost program span that covers most of it (``OUTSIDE``
    where no span covers the most): the ``top`` longest, [name, seconds];
    and by name, [name, idle seconds of every gap, gaps of at least
    ``least`` seconds], most first."""
    starts, ends, names = _innermost(p.ranges)
    named, by = [], {}
    for s, e in gaps([(d.start, d.end) for d in p.device], p.lo, p.hi):
        cover: Dict[str, float] = {}
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(starts) and starts[i] < e:
            if names[i] is not None:
                c = min(e, ends[i]) - max(s, starts[i])
                if c > 0:
                    cover[names[i]] = cover.get(names[i], 0.0) + c
            i += 1
        cover[OUTSIDE] = (e - s) - sum(cover.values())
        label = max(cover.items(), key=lambda kv: kv[1])[0]
        named.append((label, e - s))
        total, n = by.get(label, (0.0, 0))
        by[label] = (total + e - s, n + (e - s >= least))
    named.sort(key=lambda kv: -kv[1])
    return ([[k, v] for k, v in named[:top]],
            [[k, v, n] for k, (v, n) in sorted(by.items(),
                                               key=lambda kv: -kv[1][0])])


def device_ops_by_span(p: ProgramProfile):
    """Device seconds over the traced calls by the innermost span open at
    each op's launch (``OUTSIDE`` where none was), most first."""
    by: Dict[str, float] = {}
    for d in p.device:
        k = d.spans[-1] if d.spans else OUTSIDE
        by[k] = by.get(k, 0.0) + (d.end - d.start)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def device_ops_in_span(p: ProgramProfile, span: str, top: int = 5):
    """The ops that took most device time inside ``span``, by short name."""
    by: Dict[str, float] = {}
    for d in p.device:
        if span in d.spans:
            k = short_name(d.name)
            by[k] = by.get(k, 0.0) + (d.end - d.start)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            ][:top]


# -- the per-layer numbers ------------------------------------------------------

class ProgramRecord(NamedTuple):
    """What the readers read: the on windows' calls (each a request), their
    pixels, the program's trace of them, and the profile of the traced
    calls (None where none was taken)."""
    direction: str
    calls: int
    pixels: int
    trace: object  # qoipp_tpu_torch.utils.tracing.Trace
    profile: Optional[ProgramProfile]


def _in_calls(rec: ProgramRecord):
    return [s for s in rec.trace.spans if s.request >= 0]


def span_ms(rec: ProgramRecord, *names: str) -> Optional[float]:
    """Host ms a call in the spans ``names`` (None where there are none)."""
    d = [s.end_ns - s.start_ns for s in _in_calls(rec) if s.name in names]
    return 1e-6 * sum(d) / rec.calls if d and rec.calls else None


def self_ms(rec: ProgramRecord, name: str) -> Optional[float]:
    """Host ms a call in the spans ``name`` less the part of each that its
    child spans cover."""
    spans = _in_calls(rec)
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    own = [s for s in spans if s.name == name]
    if not own or not rec.calls:
        return None
    total = 0
    for s in own:
        covered, at = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, at), min(b, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        total += s.end_ns - s.start_ns - covered
    return 1e-6 * total / rec.calls


def counter(rec: ProgramRecord, name: str) -> Optional[int]:
    """The counter's total over the calls (None where it never counted)."""
    v = [n for (r, k), n in rec.trace.counters.items()
         if k == name and r >= 0]
    return sum(v) if v else None


def device_ms_in(rec: ProgramRecord, span: str) -> Optional[float]:
    """Device ms a traced call of the kernels (not copies or fills)
    launched inside ``span``."""
    p = rec.profile
    if p is None or not p.calls:
        return None
    ops = [d for d in p.device if span in d.spans and not is_transfer(d.name)]
    if not ops:
        return None
    return 1e3 * sum(d.end - d.start for d in ops) / p.calls


def _per(v, n):
    return None if v is None or not n else v / n


def _only(direction, fn):
    return lambda rec: fn(rec) if rec.direction == direction else None


READERS = {
    "host_pack_ms.batch_decode": _only(
        "decode", lambda r: span_ms(r, "host.pack_streams")),
    "host_unpack_ms.serving_decode": _only(
        "decode", lambda r: self_ms(r, "host.unpack")),
    "host_wait_ms.serving_decode": _only(
        "decode", lambda r: span_ms(r, "host.fetch", "host.sync")),
    "host_wait_ms.serving_encode": _only(
        "encode", lambda r: span_ms(r, "host.fetch", "host.sync")),
    "d2h_bytes_per_px.serving_decode": _only(
        "decode", lambda r: _per(counter(r, "d2h_bytes"), r.pixels)),
    "split_rounds_per_call.serving_decode": _only(
        "decode", lambda r: _per(counter(r, "split_rounds"), r.calls)),
    "template_rows_per_px.encode": _only(
        "encode", lambda r: _per(counter(r, "template_rows"), r.pixels)),
    "boundary_device_ms.decode": _only(
        "decode", lambda r: device_ms_in(r, "decode.boundary")),
    "templates_device_ms.encode": _only(
        "encode", lambda r: device_ms_in(r, "encode.templates")),
}


def read_all(rec: ProgramRecord) -> dict:
    out = {}
    for name, fn in READERS.items():
        v = fn(rec)
        if v is not None:
            out[name] = float(v)
    return out


# -- the run --------------------------------------------------------------------

def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.program",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of each window")
    ap.add_argument("--windows", type=int, default=3,
                    help="windows of each kind, off and on, alternating")
    return ap.parse_args(argv)


def span_cost_ns(tracing, n: int = 20000) -> dict:
    """Host ns of one span entered and left, tracing off and on."""
    def loop():
        t = time.perf_counter_ns()
        for _ in range(n):
            with tracing.span("cost"):
                pass
        return (time.perf_counter_ns() - t) / n
    off = loop()
    with tracing.collect():
        on = loop()
    return {"off": off, "on": on}


def run(args, t0: float, spec: Spec | None = None, device=None) -> dict:
    from qoipp_tpu_torch.utils import tracing

    spec = spec or Spec()
    cell = spec.cell(args.workload)
    if device is None:
        device = require_device(cell["chips"])
    traffic = spec.traffic(cell["traffic"])
    drv = drivers.make(spec, spec.config(cell["config"]), traffic,
                       args.seed, device)
    rec = Recorder()
    drv.prepare()
    _sync(device)
    drv.build()
    drv.warmup(rec)
    _sync(device)
    setup_s = time.perf_counter() - t0

    sampler = np.random.default_rng([args.seed, 2])
    keep = traffic.get("sample_calls", 2)
    samples: List[Sample] = []
    i = 0  # calls made with tracing on, each its own request

    def traced_call():
        """Call ``i`` with tracing on; a seeded reservoir of these calls
        keeps the outputs that are checked."""
        nonlocal i
        with tracing.request(i):
            out = drv.call(rec)
        s = Sample(i, out.served, out.outputs)
        if i < keep:
            samples.append(s)
        else:
            j = int(sampler.integers(0, i + 1))
            if j < keep:
                samples[j] = s
        i += 1
        return out

    rates: Dict[str, list] = {"off": [], "on": []}
    pixels, spans, counters = 0, [], {}
    for _ in range(args.windows):
        for on in (False, True):
            px, start = 0, time.perf_counter()
            with tracing.collect() if on else contextlib.nullcontext() as tr:
                while time.perf_counter() - start < args.seconds:
                    px += (traced_call() if on else drv.call(rec)).pixels
                rates["on" if on else "off"].append(
                    px / (time.perf_counter() - start) / 1e6)
            if on:
                pixels += px
                spans += tr.spans
                for k, v in tr.counters.items():
                    counters[k] = counters.get(k, 0) + v
    calls = i

    profile = None
    if device.type == "cuda":
        n = traffic.get("trace_calls", 8)
        prof = _profiler()
        with tracing.collect():
            prof.start()
            rec.profiling = True
            for _ in range(n):
                with rec.span("call"):
                    traced_call()
            prof.stop()
            rec.profiling = False
        profile = read_program_profile(prof, n)

    kind = kind_of(device)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = drv.check(samples)
    found = guard.forbidden_modules()
    if found:
        raise RuntimeError("modules of the reference package or JAX were "
                           f"loaded: {', '.join(found)}")

    trace = tracing.Trace()
    trace.spans, trace.counters = spans, counters
    prec = ProgramRecord(drv.direction, calls, pixels, trace, profile)
    by_name: Dict[str, int] = {}
    for s in spans:
        by_name[s.name] = by_name.get(s.name, 0) + 1
    totals: Dict[str, int] = {}
    for (r, k), v in counters.items():
        totals[k] = totals.get(k, 0) + v
    result = {
        "correct": all(v <= lim for v, lim in check.numbers.values()),
        "cell": cell["name"], "seed": args.seed,
        "device": {"kind": kind, "power_limit": _power_limit()
                   if device.type == "cuda" else "cpu"},
        "setup_s": setup_s,
        "mpix_s": rates,
        "on_over_off": statistics.median(rates["on"])
        / statistics.median(rates["off"]),
        "calls": calls,
        "spans_per_call": {k: v / calls for k, v in sorted(by_name.items())},
        "counters_per_call": {k: v / calls for k, v in sorted(totals.items())},
        "span_cost_ns": span_cost_ns(tracing),
        "metrics": read_all(prec),
    }
    if profile is not None:
        gaps_named, idle_by = idle_gaps_program(profile)
        result["breakdown"] = {
            "idle_gaps_program": gaps_named,
            "idle_by_span": idle_by,
            "device_ops_by_span": device_ops_by_span(profile),
            "boundary_ops": device_ops_in_span(profile, "decode.boundary"),
            "templates_ops": device_ops_in_span(profile, "encode.templates"),
            "tied": profile.tied,
            "window_s": profile.hi - profile.lo,
            "traced_calls": profile.calls}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in check.numbers.items()}
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse(argv)
    try:
        result = run(args, t0)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
