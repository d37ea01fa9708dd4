#!/usr/bin/env python
"""E3 on the card: two windows per block and a predicated long fill.

Counterpart of the repository's ``benchmarks/expt_place2.py``, which asked
whether covering two 8,192-pixel windows per TPU grid step from one fetch
(halving the per-window fixed cost), and running the fill passes of reach
8, 16 and 32 only where a chunk longer than 8 pixels exists, made the
production K2 faster.  Here one block stages one row range for two
windows (ops/place_window.place_fill2).  The three cases run at the batch
bench.py decodes, 128 images of 1080p's 284,928 rows.

    python -m qoipp_tpu_torch.benchmarks.expt_place2 [-b 128] [--rows 284928]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, describe, finish, run_variant
from ..convert import resolve_device
from ..ops import place_window as PW

CASES = (  # label, density of 1-pixel rows, fraction of run rows
    # bench-corpus-like: ~7 pixels per row, heavy runs
    ("bench-like", 0.40, 0.20),
    ("photo-ish", 0.40, 0.002),
    ("flat-runs", 0.05, 0.01),
)


def make_case(b, q, density, run_frac, seed=0):
    """(pb (b, q) int32, emits (b, q) uint32, n_cap a multiple of 2 WIN)
    (the script's generator, byte for byte)."""
    rng = np.random.default_rng(seed)
    inc = np.zeros((b, q), np.int64)
    r = rng.random((b, q))
    inc[r < density] = 1
    runs = r < run_frac
    inc[runs] = rng.integers(5, 63, runs.sum())
    pb = np.cumsum(inc, axis=1) - inc
    n_cap = -(-int(pb.max() + 70) // (2 * PW.WIN)) * (2 * PW.WIN)
    emits = rng.integers(0, 1 << 32, (b, q), dtype=np.uint64).astype(np.uint32)
    return pb.astype(np.int32), emits, n_cap


def long_fill_share(pb, n_cap: int) -> float:
    """The share of windows whose longest in-window chunk exceeds 8
    pixels: those where place_fill2 runs the fill passes of reach 8-32."""
    nxt, writes = PW.writers(pb, n_cap)
    win = torch.where(writes, pb // PW.WIN, 0).long()
    longest = torch.zeros((pb.shape[0], n_cap // PW.WIN), dtype=pb.dtype,
                          device=pb.device).scatter_reduce(
        1, win, torch.where(writes, nxt - pb, 0), "amax")
    return float((longest > 8).float().mean())


def main(argv=None, device=None) -> list:
    """Hold place_fill2 against the plain version and K2 on each case,
    then time it beside K2.  Returns the result rows; raises if any
    disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-b", type=int, default=128)
    ap.add_argument("--rows", type=int, default=284928 // 128 * 128)
    ap.add_argument("--runs", type=int, default=10,
                    help="timed launches per case; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    rows = []
    for name, dens, rf in CASES:
        pb_np, em_np, n_cap = make_case(args.b, args.rows, dens, rf)
        pb = torch.from_numpy(pb_np).to(dev)
        emits = torch.from_numpy(em_np.view(np.int32)).to(dev)
        del pb_np, em_np
        print(f"E3 [{name}]: b={args.b} q={args.rows} n_cap={n_cap}")
        base = PW.window_base_rows(pb, n_cap)
        row = run_variant(name, "two windows", lambda: PW.place_fill2(
            pb, emits, base, n_cap), pb, emits, n_cap, args.runs)
        row["long_fill_share"] = long_fill_share(pb, n_cap)
        print(describe(row))
        print(f"{'':>34}long fill in {row['long_fill_share']:.4f} of the "
              "windows")
        rows.append(row)
        del pb, emits, base
    return finish(rows)


if __name__ == "__main__":
    main()
