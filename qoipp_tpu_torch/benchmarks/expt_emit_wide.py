#!/usr/bin/env python
"""E7 on the card: byte emission over ``lanes``-wide candidate slabs.

Counterpart of the repository's ``benchmarks/expt_emit_wide.py``, which
asked whether visiting two or four 128-row slabs at once cut the TPU emit
kernel's per-visit cost.  Here ``lanes`` is base_step's slab, the unit
of each window's candidate rows (ops/emit_window.emit_wide);
``hoist`` shaped the TPU kernel's vector code only and launches the same
kernel.  Every variant is held against the plain version (K4's) and the
port's K4 on the whole output, then timed beside K4.

    python -m qoipp_tpu_torch.benchmarks.expt_emit_wide [-b 8] [--rows 131072]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, timed_ms
from ..convert import resolve_device
from ..kernels.selfcheck import max_abs_err
from ..ops import emit_kernel
from ..ops import emit_window as EW

VARIANTS = (
    ("wide256", dict(lanes=256, hoist=False)),
    ("wide256+hoist", dict(lanes=256, hoist=True)),
    ("wide512+hoist", dict(lanes=512, hoist=True)),
    ("128+hoist", dict(lanes=128, hoist=True)),
)


def gen_inputs(rng, b, c, fill=0.75):
    """(off (b, c) int32, tlo (b, c) uint32, thn (b, c) uint32, out_cap):
    the script's compacted chunk rows, byte for byte: strictly increasing
    off on real rows (1..6 bytes each), a sentinel row after the last real
    chunk, flat padding beyond (one shared off)."""
    nreal = int(c * fill) - 2
    nb = rng.integers(1, 7, (b, c))
    off = 14 + np.cumsum(nb, axis=1) - nb
    sent = off[:, nreal]  # sentinel: one past the last real chunk's end
    off[:, nreal:] = sent[:, None]
    tlo = rng.integers(0, 1 << 32, (b, c), dtype=np.uint64).astype(np.uint32)
    thn = rng.integers(0, 1 << 16, (b, c), dtype=np.uint64).astype(np.uint32)
    out_cap = -(-int(off.max() + 8) // EW.WIN) * EW.WIN
    return off.astype(np.int32), tlo, thn, out_cap


def describe(row: dict) -> str:
    """One line of the report."""
    ok = row["max_abs_err"] == 0 and row["k4_err"] == 0
    text = (f"{row['variant']:>20}: parity {'OK' if ok else 'FAIL'} (plain "
            f"{row['max_abs_err']}, K4 {row['k4_err']})")
    if row["ms"] is not None:
        text += (f"  {row['ms']:.4f} ms, K4 {row['k4_ms']:.4f} ms "
                 f"({row['k4_ms'] / row['ms']:.2f}x)")
    return text


def main(argv=None, device=None) -> list:
    """Hold every variant against the plain version and K4 on the whole
    output, then time it beside K4.  Returns the result rows; raises if
    any disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("-b", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed launches per variant; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    off_np, tlo_np, thn_np, out_cap = gen_inputs(np.random.default_rng(0),
                                                 args.b, args.rows)
    off = torch.from_numpy(off_np).to(dev)
    tlo, thn = (torch.from_numpy(x.view(np.int32)).to(dev)
                for x in (tlo_np, thn_np))
    nwin = args.b * out_cap // EW.WIN
    print(f"E7: b={args.b} rows={args.rows} out_cap={out_cap} "
          f"({nwin} windows)")
    want = EW.emit_wide_reference(off, tlo, thn, out_cap)
    k4 = lambda: emit_kernel.emit_bytes(off, tlo, thn, out_cap)
    k4_out = k4().to(torch.int32)
    rows = []
    for name, kw in VARIANTS:
        base = EW.window_base_rows_w(off, out_cap, kw["lanes"])
        call = lambda kw=kw, base=base: EW.emit_wide(off, tlo, thn, base,
                                                     out_cap, **kw)
        got = call()
        row = dict(variant=name, max_abs_err=max_abs_err(got, want),
                   k4_err=max_abs_err(got, k4_out), ms=None, k4_ms=None)
        if args.runs:
            row["ms"] = timed_ms(call, runs=args.runs)
            row["k4_ms"] = timed_ms(k4, runs=args.runs)
        print(describe(row))
        if row["ms"] is not None:
            print(f"{'':>22}{row['ms'] / nwin * 1e3:.3f} us/window")
        rows.append(row)
    bad = [r["variant"] for r in rows
           if r["max_abs_err"] != 0 or r["k4_err"] != 0]
    if bad:
        raise RuntimeError(f"variants disagree: {bad}")
    return rows


if __name__ == "__main__":
    main()
