"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, the metrics, and the result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines of standard error.

With ``--trace 1`` the program's own spans and counters
(``qoipp_tpu_torch.utils.tracing``) are collected from the window's start
to the traced calls' end, each call a ``tracing.request`` of its own; the
metrics read them from ``Record.program`` (``portbench.program``): host
readings over the window's calls, device ops by span over the traced
calls.  ``--trace 0`` never imports the program's tracing.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import subprocess
import sys
import time
import traceback
from typing import TYPE_CHECKING, List, NamedTuple, Optional

import numpy as np
import torch

from . import drivers, guard
from .spec import Spec
from .trace import (DeviceTrace, Recorder, breakdown, is_transfer,
                    port_kernel, read_profile)

if TYPE_CHECKING:  # program.py imports this module
    from .program import ProgramRecord


class Sample(NamedTuple):
    call: int
    served: object
    outputs: object


class Record(NamedTuple):
    """What a metric's reader reads."""
    direction: str
    setup_s: float
    window_s: float
    latencies: List[float]  # seconds, every call of the window
    items: int
    pixels: int  # every call of the window
    spans: list  # trace.Span, every call of the window
    trace: Optional[DeviceTrace]
    work: dict  # roofline.Work a call, by kernel
    device_kind: str
    # the program's own spans and counters (--trace 1, where the port has
    # them): host ones of the window's calls, device ops by span of the
    # traced calls
    program: Optional["ProgramRecord"] = None


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the cell's control (a codec that breaks a "
                    "guarantee the configuration states) in the program's "
                    "place; the benchmark's own runs never do")
    return ap.parse_args(argv)


def require_device(chips: int):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "false")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} CUDA devices, "
                           f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kind_of(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _whole(t: DeviceTrace, kernels) -> bool:
    """Whether CUPTI kept the trace whole: a call span for each traced
    call, device events of each of ``kernels`` (the program's, by
    function name; any of them where none is named) and of the torch
    passes."""
    found = {port_kernel(e.name) for e in t.device} - {None}
    passes = any(not port_kernel(e.name) and not is_transfer(e.name)
                 for e in t.device)
    calls = sum(s.name == "call" for s in t.spans)
    return (calls == t.calls and passes
            and (set(kernels) <= found if kernels else bool(found)))


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _program_tracing():
    """The port's tracing module, or None in a checkout whose port has
    none."""
    name = "qoipp_tpu_torch.utils.tracing"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def _window_only(tracing, collected, calls: int):
    """The spans and counters of the window's calls (requests 0 .. calls
    - 1), not of the traced calls after it."""
    t = tracing.Trace()
    t.spans = [s for s in collected.spans if 0 <= s.request < calls]
    t.counters = {k: v for k, v in collected.counters.items()
                  if 0 <= k[0] < calls}
    return t


def run(args, t0: float, spec: Spec | None = None, device=None) -> dict:
    """One run; ``device`` None means the card the cell asks for (the
    tests pass the CPU, where the program runs its plain versions).  The
    process's torch thread count is as it was afterwards."""
    threads = torch.get_num_threads()
    try:
        return _run(args, t0, spec or Spec(), device)
    finally:
        torch.set_num_threads(threads)


def _run(args, t0: float, spec: Spec, device) -> dict:
    cell = spec.cell(args.workload)
    if device is None:
        device = require_device(cell["chips"])
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    # a traffic file may hold torch's host work to a few threads: a
    # host-bound call then does not wait on a pool of threads that a busy
    # host deschedules one by one
    if "host_threads" in traffic:
        torch.set_num_threads(int(traffic["host_threads"]))
    wanted = (spec.per_layer(cell["name"]) if args.trace
              else spec.end_to_end(cell["name"]))
    drv = drivers.make(spec, config, traffic, args.seed, device,
                       bool(args.control))
    rec = Recorder()
    drv.prepare()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv.build()
    drv.warmup(rec)
    _sync(device)
    rec.spans.clear()
    # the program's own tracing (--trace 1): on from the window's start to
    # the traced calls' end; with --trace 0 never imported
    tracing = _program_tracing() if args.trace else None
    if tracing is not None:
        from . import program  # which imports this module

    # -- the window ----------------------------------------------------------
    sampler = np.random.default_rng([args.seed, 2])
    keep = traffic.get("sample_calls", 2)
    samples: List[Sample] = []

    def timed(i: int):
        """Call ``i``, timed; a seeded reservoir of the calls keeps the
        outputs that are checked."""
        rec.call = i
        request = (tracing.request(i) if tracing is not None
                   else contextlib.nullcontext())
        start = time.perf_counter()
        with rec.span("call"), request:
            out = drv.call(rec)
        latency = time.perf_counter() - start
        s = Sample(i, out.served, out.outputs)
        if i < keep:
            samples.append(s)
        else:
            j = int(sampler.integers(0, i + 1))
            if j < keep:
                samples[j] = s
        return latency, out.items, out.pixels

    latencies, items, pixels = [], 0, 0
    tr, profile = None, None
    trace_calls = traffic.get("trace_calls", 8)
    with (tracing.collect() if tracing is not None
          else contextlib.nullcontext()) as collected:
        first = time.perf_counter()
        setup_s = first - t0
        window_s = 0.0
        while window_s < args.seconds:
            latency, n, px = timed(len(latencies))
            latencies.append(latency)
            items, pixels = items + n, pixels + px
            window_s = time.perf_counter() - first
        spans = list(rec.spans)

        # -- the traced calls, after the window: the profiler slows the
        # calls it traces, and none of the window's ---------------------------
        i = len(latencies)
        for tries in range(1, 3) if args.trace else ():
            prof = _profiler()
            prof.start()
            rec.profiling = True
            for _ in range(trace_calls):
                _, n, _ = timed(i)
                items, i = items + n, i + 1
            prof.stop()
            rec.profiling = False
            t = read_profile(prof, trace_calls)
            # CUPTI at times drops a trace's events, or some of them: a
            # trace that is not whole is taken again, once
            if t.device and (tries == 2
                             or _whole(t, traffic.get("trace_kernels", []))):
                tr = t
                if tracing is not None:
                    profile = program.read_program_profile(prof, trace_calls)
                break
    if args.trace and tr is None:
        raise RuntimeError("torch.profiler kept no device event in two "
                           f"traces of {trace_calls} calls")
    prog = None
    if tracing is not None:
        prog = program.ProgramRecord(
            drv.direction, len(latencies), pixels,
            _window_only(tracing, collected, len(latencies)), profile)

    # -- after the window: memory, the reference, the guard ------------------
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = kind_of(device)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = drv.check(samples)
    found = guard.forbidden_modules()
    if found:
        raise RuntimeError("modules of the reference package or JAX were "
                           f"loaded: {', '.join(found)}")

    record = Record(drv.direction, setup_s, window_s, latencies, items,
                    pixels, spans, tr, drv.work, kind, prog)
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(record)
        if value is None:
            if not args.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in check.numbers.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell["chips"] if device.type == "cuda"
           else 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(correct), "attempted": items,
              "failed": check.wrong if correct else max(check.wrong, 1),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
        if profile is not None:
            named, by_span = program.idle_gaps_program(profile)
            result["breakdown"].update(
                idle_gaps_program=named,
                idle_by_span=[[k, v] for k, v, _ in by_span[:10]],
                device_ops_by_span=program.device_ops_by_span(profile)[:10])
    result["compared"] = check.compared
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in check.numbers.items()}
    return result


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    try:
        result = run(args, t0)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    print(f"outputs compared: {result['compared']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
