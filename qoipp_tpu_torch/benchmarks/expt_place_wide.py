#!/usr/bin/env python
"""E2 on the card: windowed placement over ``lanes``-wide candidate slabs.

Counterpart of the repository's ``benchmarks/expt_place_wide.py``, which
asked whether visiting two or four 128-row slabs at once (and hoisting
the per-row mask arithmetic) cut the TPU kernel's per-visit cost.  Here
``lanes`` is base_step's slab, the unit of each window's candidate rows
(ops/place_window.place_wide, csrc/place_window.cu); ``hoist`` shaped the
TPU kernel's vector code only and launches the same kernel.

    python -m qoipp_tpu_torch.benchmarks.expt_place_wide [-b 8] [--rows 524288]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, describe, finish, run_variant
from ..convert import resolve_device
from ..ops import place_window as PW

VARIANTS = (
    ("wide256", dict(lanes=256, hoist=False)),
    ("wide256+hoist", dict(lanes=256, hoist=True)),
    ("wide512+hoist", dict(lanes=512, hoist=True)),
    ("128+hoist", dict(lanes=128, hoist=True)),
    ("128 aligned-groups", dict(lanes=128, hoist=False)),
)


def gen_inputs(rng, b, q, density=0.40, run_p=0.002):
    """(pb (b, q) int32, emits (b, q) uint32, n_cap): photo-like rows,
    ~0.47 pixels per row (the script's generator, byte for byte)."""
    inc = np.zeros((b, q), np.int64)
    r = rng.random((b, q))
    inc[r < density] = 1
    runs = r < run_p
    inc[runs] = rng.integers(5, 63, runs.sum())
    pb = np.cumsum(inc, axis=1) - inc
    n_cap = -(-int(pb.max() + 70) // PW.WIN) * PW.WIN
    emits = rng.integers(0, 1 << 32, (b, q), dtype=np.uint64).astype(
        np.uint32)
    return pb.astype(np.int32), emits, n_cap


def main(argv=None, device=None) -> list:
    """Hold every variant against the plain version and K2, then time it
    beside K2.  Returns the result rows; raises if any disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("-b", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed launches per variant; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    pb_np, em_np, n_cap = gen_inputs(np.random.default_rng(0), args.b,
                                     args.rows)
    pb = torch.from_numpy(pb_np).to(dev)
    emits = torch.from_numpy(em_np.view(np.int32)).to(dev)
    nwin = args.b * n_cap // PW.WIN
    print(f"E2: b={args.b} q={args.rows} n_cap={n_cap} ({nwin} windows)")
    rows = []
    for name, kw in VARIANTS:
        base = PW.window_base_rows_w(pb, n_cap, kw["lanes"])
        row = run_variant("photo", name, lambda kw=kw, base=base:
                          PW.place_wide(pb, emits, base, n_cap, **kw),
                          pb, emits, n_cap, args.runs)
        print(describe(row))
        if row["ms"] is not None:
            print(f"{'':>34}{row['ms'] / nwin * 1e3:.3f} us/window, "
                  f"{row['ms'] * 1e6 / (args.b * args.rows / 128):.2f} ns "
                  "per 128 rows")
        rows.append(row)
    return finish(rows)


if __name__ == "__main__":
    main()
