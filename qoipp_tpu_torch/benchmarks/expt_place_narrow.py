#!/usr/bin/env python
"""E5 on the card: narrow groups placed output-driven.

Counterpart of the repository's ``benchmarks/expt_place_narrow.py``, which
asked whether a 128-row slab whose chunks cover a few 128-pixel stripes
should take a small (2 NS, 128) one-hot product on the TPU's matrix unit
instead of the whole window's.  Here the question becomes gather or
scatter: a warp's group of 128 rows whose writers span at most ``ns``
stripes gets each mask word of the span from one warp reduction, and
wider groups an atomic a word per lane (ops/place_window
.place_fill_narrow).

    python -m qoipp_tpu_torch.benchmarks.expt_place_narrow [-b 8] [--rows 524288]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, describe, finish, run_variant
from ..convert import resolve_device
from ..ops import place_window as PW

CASES = (("photo (few runs)", 0.002), ("runny (icons)", 0.02))  # run_frac
NS = (2, 4)


def gen_case(rng, b, q, run_frac):
    """(pb (b, q) int32, emits (b, q) uint32, n_cap): photo-like chunk
    structure (the script's generator, byte for byte)."""
    inc = np.zeros((b, q), np.int64)
    r = rng.random((b, q))
    # chunk starts ~40%: 1 px each; occasional run rows: 5..62 px
    inc[r < 0.40] = 1
    runs = r < run_frac
    inc[runs] = rng.integers(5, 63, runs.sum())
    pb = np.cumsum(inc, axis=1) - inc
    emits = rng.integers(0, 1 << 32, (b, q), dtype=np.uint64).astype(np.uint32)
    n_px = int(pb.max() + 70)
    n_cap = -(-n_px // PW.WIN) * PW.WIN
    return pb.astype(np.int32).clip(0, n_cap), emits, n_cap


def narrow_share(pb, n_cap: int, ns: int) -> float:
    """The share of (128-row group, window) pairs with writers whose
    writers span at most ns stripes of 128 pixels: those place_fill_narrow
    places output-driven."""
    b, q = pb.shape
    nwin = n_cap // PW.WIN
    writes = PW.writers(pb, n_cap)[1]
    group = torch.arange(q, device=pb.device)[None, :] // PW.SLAB
    key = torch.where(writes, group * nwin + pb // PW.WIN, 0)
    stripe = (pb % PW.WIN) // 128
    shape = (b, -(-q // PW.SLAB) * nwin)
    lo = torch.full(shape, PW.SW, dtype=pb.dtype, device=pb.device)
    lo = lo.scatter_reduce(1, key, torch.where(writes, stripe, PW.SW), "amin")
    hi = torch.full(shape, -1, dtype=pb.dtype, device=pb.device)
    hi = hi.scatter_reduce(1, key, torch.where(writes, stripe, -1), "amax")
    live = hi >= 0
    return float((live & (hi - lo < ns)).sum() / live.sum())


def main(argv=None, device=None) -> list:
    """Hold place_fill_narrow at each ns against the plain version and K2
    on both cases, then time it beside K2.  Returns the result rows;
    raises if any disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-b", type=int, default=8)
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed launches per variant; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    rng = np.random.default_rng(0)
    rows = []
    for label, run_frac in CASES:
        pb_np, em_np, n_cap = gen_case(rng, args.b, args.rows, run_frac)
        pb = torch.from_numpy(pb_np).to(dev)
        emits = torch.from_numpy(em_np.view(np.int32)).to(dev)
        base = PW.window_base_rows(pb, n_cap)
        npx = int(pb_np.max())
        print(f"E5 [{label}]: b={args.b} q={args.rows} n_cap={n_cap}")
        for ns in NS:
            row = run_variant(label, f"narrow NS={ns}", lambda ns=ns:
                              PW.place_fill_narrow(pb, emits, base, n_cap,
                                                   ns=ns),
                              pb, emits, n_cap, args.runs)
            row["narrow_share"] = narrow_share(pb, n_cap, ns)
            print(describe(row))
            print(f"{'':>34}output-driven: {row['narrow_share']:.4f} of the "
                  "groups")
            if row["ms"] is not None:
                print(f"{'':>34}{args.b * npx / row['ms'] / 1e3:.0f} MPix/s "
                      "equivalent")
            rows.append(row)
    return finish(rows)


if __name__ == "__main__":
    main()
