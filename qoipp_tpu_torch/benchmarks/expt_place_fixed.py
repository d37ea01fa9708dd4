#!/usr/bin/env python
"""E6 on the card: stage ablations of the windowed placement.

Counterpart of the repository's ``benchmarks/expt_place_fixed.py``, which
located the TPU K2's per-window fixed cost by knocking stages out: the row
fetch (``do_dma``), the placement (``do_slabs``) and the fill passes
(``n_fill``), at two matrix-unit precisions (``prec``, one launch here).
The ablated variants compute another function (ops/place_window
.place_variant); each is held against the plain version at its own knobs,
and the full ones against K2 as well.

    python -m qoipp_tpu_torch.benchmarks.expt_place_fixed [-b 8] [--rows 524288]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, describe, finish, run_variant
from ..convert import resolve_device
from ..ops import place_window as PW

VARIANTS = (
    ("full/highest", dict(prec="highest")),
    ("full/bytes4", dict(prec="bytes4")),
    ("no-fill", dict(n_fill=0)),
    ("fill-3", dict(n_fill=3)),
    ("no-slabs", dict(do_slabs=False)),
    ("no-dma", dict(do_dma=False, do_slabs=False)),
    ("dma-only", dict(do_slabs=False, n_fill=0)),
    ("bare", dict(do_dma=False, do_slabs=False, n_fill=0)),
    ("b4-nofill", dict(n_fill=0, prec="bytes4")),
    ("b4-fill3", dict(n_fill=3, prec="bytes4")),
    ("b4-noslab", dict(do_slabs=False, prec="bytes4")),
    ("b4-dmaonly", dict(do_slabs=False, n_fill=0, prec="bytes4")),
)


def gen_inputs(rng, b, q):
    """(pb (b, q) int32, emits (b, q) uint32, n_cap): the script's inline
    photo-like inputs, byte for byte."""
    inc = np.zeros((b, q), np.int64)
    r = rng.random((b, q))
    inc[r < 0.40] = 1
    runs = r < 0.002
    inc[runs] = rng.integers(5, 63, runs.sum())
    pb = np.cumsum(inc, axis=1) - inc
    n_cap = -(-int(pb.max() + 70) // PW.WIN) * PW.WIN
    emits = rng.integers(0, 1 << 32, (b, q), dtype=np.uint64).astype(np.uint32)
    return pb.astype(np.int32), emits, n_cap


def main(argv=None, device=None) -> list:
    """Hold every variant against the plain version at its knobs (and the
    full ones against K2), then time it beside K2.  Returns the result
    rows; raises if any disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-b", type=int, default=8)
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed launches per variant; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    pb_np, em_np, n_cap = gen_inputs(np.random.default_rng(0), args.b,
                                     args.rows)
    pb = torch.from_numpy(pb_np).to(dev)
    emits = torch.from_numpy(em_np.view(np.int32)).to(dev)
    base = PW.window_base_rows(pb, n_cap)
    nwin = args.b * n_cap // PW.WIN
    print(f"E6: b={args.b} q={args.rows} n_cap={n_cap} ({nwin} windows)")
    rows = []
    for name, kw in VARIANTS:
        row = run_variant("photo", name, lambda kw=kw: PW.place_variant(
            pb, emits, base, n_cap, **kw), pb, emits, n_cap, args.runs,
            kw.get("n_fill", 6), kw.get("do_slabs", True))
        print(describe(row))
        if row["ms"] is not None:
            print(f"{'':>34}{row['ms'] / nwin * 1e3:.3f} us/window")
        rows.append(row)
    return finish(rows)


if __name__ == "__main__":
    main()
