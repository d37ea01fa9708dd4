#!/usr/bin/env python
"""E4 on the card: the grouped summed placement over steps of G windows.

Counterpart of the repository's ``benchmarks/expt_place.py``, which timed
round-2 variants of the TPU placement kernel: one-hot matrix-unit dots per
128-row slab, steps of G windows of WIN pixels, and ways to find each
window's candidate rows (``lr_mode``).  Its function adds the rows that
share a pixel (ops/place_window.summed_place_reference); the script's
generator has none, so there the exact variant also equals K2 up to each
image's last chunk start.  The "STATIC-IN" variant reads a fixed row range
whatever the window, as on the TPU: it is timed, not compared.
``precision``, ``fuse_dot`` and ``emit_whole`` shaped the TPU's dots only.

    python -m qoipp_tpu_torch.benchmarks.expt_place [-b 128] [--runs 6]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, describe, finish, prefix_err, timed_ms
from ..convert import resolve_device
from ..kernels.selfcheck import max_abs_err
from ..ops import place_kernel
from ..ops import place_window as PW

B, N_CAP, CAP = 128, 2088960, 286720  # the script's sizes
# (name, WIN, G, precision, fuse_dot, emit_whole, lr_mode, static_inputs)
VARIANTS = (
    ("W8192,G1 dyn STATIC-IN (timing)", 8192, 1, "highest", False, True,
     "dyn", True),
    ("W8192,G1 dyn elem-in", 8192, 1, "highest", False, True, "dyn", False),
)


def make_variant(win, g, precision, fuse_dot, emit_whole, lr_mode="cnt",
                 static_inputs=False):
    """The script's factory: ``run(pb, emits, base_step, n_cap)`` places
    over steps of g windows of win pixels (ops/place_window
    .place_grouped).  Returns (B, n_cap) int32."""
    def run(pb_c, emit_c, base_step, n_cap=N_CAP):
        return PW.place_grouped(pb_c, emit_c, base_step, n_cap, win=win, g=g,
                                lr_mode=lr_mode, static_inputs=static_inputs,
                                precision=precision, fuse_dot=fuse_dot,
                                emit_whole=emit_whole)
    return run


def gen_inputs(rng, b=B, n_cap=N_CAP, cap=CAP):
    """(pb (b, cap) int32, emits (b, cap) uint32, counts (b,) int32): the
    script's inline generator, byte for byte; chunks of 1-62 pixels, no
    two rows on one pixel, rows past each image's count at pb = n_cap."""
    pb = np.full((b, cap), n_cap, np.int32)
    em = np.zeros((b, cap), np.uint32)
    counts = np.zeros(b, np.int32)
    for i in range(b):
        produced = rng.choice([1, 1, 1, 1, 2, 3, 5, 17, 62], size=250000)
        pos = np.concatenate([[0], np.cumsum(produced)[:-1]])
        c = int(np.searchsorted(pos, n_cap))
        pb[i, :c] = pos[:c]
        em[i, :c] = rng.integers(0, 2**32, c, dtype=np.uint64).astype(
            np.uint32)
        counts[i] = c
    return pb, em, counts


def base_rows(pb, n_cap: int, win: int, g: int, lr_mode: str):
    """The script's base_step: one slab per step, per window in smem mode
    (int32; the script's int16 fitted the TPU's scalar memory)."""
    return PW.step_base_rows(pb, n_cap, win if lr_mode == "smem" else win * g)


def main(argv=None, device=None) -> list:
    """Hold the exact variant against the plain version on the whole
    output and against K2 up to each image's last chunk start, time every
    variant beside K2.  Returns the result rows; raises if any disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-b", type=int, default=B)
    ap.add_argument("--cap", type=int, default=CAP, help="rows per image")
    ap.add_argument("--n-cap", type=int, default=N_CAP)
    ap.add_argument("--runs", type=int, default=6,
                    help="timed launches per variant; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    n_cap = args.n_cap
    pb_np, em_np, counts = gen_inputs(np.random.default_rng(0), args.b,
                                      n_cap, args.cap)
    pb = torch.from_numpy(pb_np).to(dev)
    emits = torch.from_numpy(em_np.view(np.int32)).to(dev)
    del pb_np, em_np
    print(f"E4: b={args.b} cap={args.cap} n_cap={n_cap} "
          f"({int(counts.sum())} rows placed)")
    k2 = lambda: place_kernel.place_fill(pb, emits, n_cap)
    rows = []
    for name, win, g, prec, fuse, whole, mode, static_in in VARIANTS:
        base = base_rows(pb, n_cap, win, g, mode)
        run = make_variant(win, g, prec, fuse, whole, mode, static_in)
        call = lambda run=run, base=base: run(pb, emits, base, n_cap=n_cap)
        got = call()
        row = dict(case=f"B={args.b}", variant=name, max_abs_err=None,
                   k2_err=None, ms=None, k2_ms=None)
        if not static_in and mode != "static":
            row["max_abs_err"] = max_abs_err(
                got, PW.summed_place_reference(pb, emits, n_cap, win, g))
            row["k2_err"] = prefix_err(got, k2(), pb, n_cap)
        del got
        if args.runs:
            row["ms"] = timed_ms(call, runs=args.runs)
            row["k2_ms"] = timed_ms(k2, runs=args.runs)
        print(describe(row))
        if row["ms"] is not None:
            nsteps = args.b * n_cap // (win * g)
            print(f"{'':>34}{row['ms'] / nsteps * 1e6:.1f} ns/step")
        rows.append(row)
    return finish(rows)


if __name__ == "__main__":
    main()
