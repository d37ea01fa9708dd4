#!/usr/bin/env python
"""K3 at the packed-encode shape on the card.

Counterpart of the repository's ``benchmarks/expt_compact.py``, which swept
the TPU compaction kernel's block size and section packing at the real
corpus's packed-encode shape: 12 lanes x 917,504 rows, cap 458,752, two
planes (a 32-bit word and a 24-bit position|flag word), keep ~0.45
(inputs made by the script's generator, byte for byte).  The script's
``quarters`` and ``secbits`` ablations (and its 16-bit/8-bit exactness
check) choose Mosaic's layout of the byte sections; nothing in K3
(csrc/compact.cu) corresponds, so they are not carried.  Nor is the block
sweep: the port's compact_rows takes no block size (its tile comes from
the built library, compact_kernel.launch_shape).  So the one K3 is held
against its plain version (compact_rows_reference: counts, and every row
below each lane's count) and timed beside it: CUDA-event ms, device ms
and launches (torch.profiler), and rows a microsecond.

    python -m qoipp_tpu_torch.benchmarks.expt_compact [--runs 5]
    python -m qoipp_tpu_torch.benchmarks.expt_compact --device cpu --runs 0 --lanes 2 --rows 8192 --cap 4096
"""

from __future__ import annotations

import numpy as np
import torch

from . import stages as S
from ..ops import compact_kernel

L, NP, CAP = 12, 896 << 10, 448 << 10  # the script's shape


def gen_inputs(lanes: int, rows: int, dev):
    """keep (lanes, rows) bool at density 0.45 and two int32 planes, the
    script's generator (seed 0), byte for byte."""
    rng = np.random.default_rng(0)
    keep = rng.random((lanes, rows)) < 0.45
    p0 = rng.integers(0, 1 << 32, (lanes, rows), dtype=np.uint32)
    p1 = rng.integers(0, 1 << 24, (lanes, rows), dtype=np.uint32)
    return (torch.from_numpy(keep).to(dev),
            torch.from_numpy(p0.view(np.int32)).to(dev),
            torch.from_numpy(p1.view(np.int32)).to(dev))


def same_below_counts(got, want) -> bool:
    """Two compact_rows results agree: counts, and each plane's rows below
    each lane's count (the rest are unspecified)."""
    (gp, gc), (wp, wc) = got, want
    if not torch.equal(gc, wc):
        return False
    live = (torch.arange(gp[0].shape[1], device=gc.device)[None, :]
            < gc.clamp(max=gp[0].shape[1])[:, None])
    return all(torch.equal(torch.where(live, g, 0), torch.where(live, w, 0))
               for g, w in zip(gp, wp))


def main(argv=None, device=None) -> dict:
    """Hold K3 against its plain version at the script's shape, then time
    both.  Returns the row."""
    ap = S.parser(__doc__)
    ap.add_argument("--lanes", type=int, default=L)
    ap.add_argument("--rows", type=int, default=NP)
    ap.add_argument("--cap", type=int, default=CAP)
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    keep, p0, p1 = gen_inputs(args.lanes, args.rows, dev)

    def k3():
        return compact_kernel.compact_rows((p0, p1), keep, cap=args.cap)

    def plain():
        return compact_kernel.compact_rows_reference((p0, p1), keep,
                                                     args.cap)

    S.expect(same_below_counts(k3(), plain()),
             "K3 differs from its plain version")
    kept = int(keep.sum())
    print(f"K3 at {args.lanes} x {args.rows} rows, cap {args.cap}, 2 "
          f"planes, {kept} kept: equal to its plain version")
    out = dict(kept=kept)
    if args.runs:
        out["k3"], out["plain"] = S.measure(k3, args.runs), S.measure(
            plain, args.runs)
        total = args.lanes * args.rows
        for name in ("k3", "plain"):
            r = out[name]
            print(f"{name:>6}: {r['ms']:.4f} ms, device {r['device_ms']:.4f}"
                  f" ms, {r['launches']:g} launches "
                  f"({total / r['ms'] / 1e3:.0f} Mrow/s)")
    return out


if __name__ == "__main__":
    main()
