"""The TPU experiments E2-E9 of the repository's ``benchmarks/`` on the card.

One module per experiment script, under the same file name:
``expt_place_wide`` (E2), ``expt_place2`` (E3), ``expt_place`` (E4),
``expt_place_narrow`` (E5), ``expt_place_fixed`` (E6), ``expt_emit_wide``
(E7) and ``profile_r2`` (E8, E9 and the probes around them).  Each carries
a byte-equal numpy copy of its script's input generator, its variants and
its sizes, and a ``main`` that holds every variant against its plain
version on the whole output and, where the variant computes the
production function, against the port's K2 (E4 up to each image's last
chunk start, the others on the whole output) or K4, then times the variant
beside it with CUDA events:

    python -m qoipp_tpu_torch.benchmarks.expt_place_wide

``--runs 0`` checks parity alone, which also runs on the CPU.  The helpers
below are what the placement experiments share.
"""

from __future__ import annotations

import torch

from ..kernels.selfcheck import max_abs_err
from ..ops import place_kernel
from ..ops.place_kernel import place_fill_reference, writers


def timed_ms(fn, warmup: int = 3, runs: int = 5) -> float:
    """Mean ms of fn over ``runs`` launches after ``warmup``, by CUDA
    events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def last_chunk_start(pb, n_cap: int):
    """(B,) the pixel of each image's last writing row below n_cap (-1 if
    none)."""
    return torch.where(writers(pb, n_cap)[1], pb, -1).amax(dim=1)


def prefix_err(got, want, pb, n_cap: int) -> int:
    """max |got - want| over each image's pixels up to its last chunk
    start."""
    px = torch.arange(n_cap, device=pb.device)[None, :]
    keep = px <= last_chunk_start(pb, n_cap)[:, None]
    return max_abs_err(torch.where(keep, got, 0), torch.where(keep, want, 0))


def run_variant(case: str, name: str, call, pb, emits, n_cap: int,
                runs: int, n_fill: int = 6, place: bool = True) -> dict:
    """Run ``call()`` (a wrapper on pb, emits), hold it against the plain
    windowed placement at (n_fill, place) and, for an exact variant, K2's
    whole output; time it and K2 if ``runs``.  Returns the result row."""
    got = call()
    want = place_fill_reference(pb, emits, n_cap, n_fill, place)
    row = dict(case=case, variant=name, max_abs_err=max_abs_err(got, want),
               k2_err=None, ms=None, k2_ms=None)
    del want
    k2 = lambda: place_kernel.place_fill(pb, emits, n_cap)
    if n_fill == 6 and place:
        row["k2_err"] = max_abs_err(got, k2())
    del got
    if runs:
        row["ms"] = timed_ms(call, runs=runs)
        row["k2_ms"] = timed_ms(k2, runs=runs)
    return row


def describe(row: dict) -> str:
    """One line of an experiment's report; a max_abs_err of None marks a
    timing-only variant, whose output is not compared."""
    if row["max_abs_err"] is None:
        parity = "not compared (timing only)"
    else:
        ok = row["max_abs_err"] == 0 and row["k2_err"] in (None, 0)
        parity = (f"{'OK' if ok else 'FAIL'} (plain {row['max_abs_err']}, "
                  f"K2 "
                  f"{'-' if row['k2_err'] is None else row['k2_err']})")
    text = f"{row['case']:>12} {row['variant']:>20}: parity {parity}"
    if row["ms"] is not None:
        text += (f"  {row['ms']:.4f} ms, K2 {row['k2_ms']:.4f} ms "
                 f"({row['k2_ms'] / row['ms']:.2f}x)")
    return text


def finish(rows: list) -> list:
    """Raise if any variant disagreed; else return the rows."""
    bad = [f"{r['case']}/{r['variant']}" for r in rows
           if r["max_abs_err"] not in (None, 0)
           or r["k2_err"] not in (None, 0)]
    if bad:
        raise RuntimeError(f"variants disagree: {bad}")
    return rows


def check_timing(device: torch.device, runs: int) -> None:
    if runs and device.type != "cuda":
        raise ValueError("timing needs a CUDA device: pass --runs 0 for "
                         "parity alone")
