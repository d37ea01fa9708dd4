"""Timing and profiling helpers: the port of ``qoipp_tpu.utils.timing``.

``time_ms`` is the host clock around whole calls (what a caller waits
for), ``device_time_ms`` the card's own time between two CUDA events,
``mpix_per_s`` the bench's headline unit and ``trace`` a torch.profiler
context that writes a Chrome trace.  A card's work is asynchronous to the
host, so every timer here waits for the card before it reads its clock.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_ms(fn: Callable, runs: int = 5, warmup: int = 1) -> float:
    """Host-clock ms of fn(), the mean of ``runs`` calls after ``warmup``;
    the card, where one is in use, is waited for after the warmups and
    after the timed calls."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    _sync()
    return (time.perf_counter() - t0) / runs * 1e3


def device_time_ms(fn: Callable, *args, runs: int = 10) -> float:
    """Card ms of fn(*args): one warmup call, then the mean of ``runs``
    calls between two CUDA events.  Raises where there is no card: a
    device time is never taken on the host."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device")
    fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def mpix_per_s(n_pixels: int, ms: float) -> float:
    """Megapixels a second of n_pixels in ms milliseconds."""
    return n_pixels / (ms * 1e-3) / 1e6 if ms > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler over the body (the card's kernels too, where one is
    in use); on exit writes ``trace.json``, a Chrome trace (Perfetto or
    chrome://tracing), into ``log_dir`` (by default a new temporary
    directory) and yields that directory."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir or tempfile.mkdtemp(prefix="qoipp_tpu_torch_trace_"))
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield out
        _sync()
    prof.export_chrome_trace(str(out / "trace.json"))
