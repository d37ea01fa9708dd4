#!/usr/bin/env python
"""The card's transfer rates against transfer granularity.

Counterpart of the repository's ``benchmarks/expt_h2d_chunks.py``, which
asked whether cutting a large upload into mid-size pieces (and joining
them on the device) beat one large transfer on the TPU's host link.  For
a ``--mb`` MB payload (random bytes, seed 0, as (rows, 128) uint8) cut
into N = 1, 2, 4, ..., 256 axis-0 pieces, best of ``--reps`` by the host
clock, the card waited for:

  pageable  each piece copied from pageable host memory (``.to``);
  pinned    each piece copied from pinned host memory (pinned before the
            clock starts), ``non_blocking``;
  staged    utils/transport.stage_h2d of the whole payload at a chunk size
            of payload / N: each piece pinned and copied into its slice of
            one device tensor (what the engines' uploads do with chunking
            set; N = 1 is the unchunked upload);
  D2H       each device piece fetched to pageable host memory (``.cpu``).

Before anything is timed, stage_h2d's output at every N must equal the
payload.  ``--runs 0`` checks that alone (it also runs on the CPU).

    python -m qoipp_tpu_torch.benchmarks.expt_h2d_chunks [--mb 54]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import stages as S
from ..utils import transport

PIECES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _best_s(fn, reps: int) -> float:
    """Best host-clock seconds of fn() over reps calls, the card waited
    for inside each."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def staged(host: np.ndarray, n: int, dev) -> torch.Tensor:
    """stage_h2d of host at a chunk size of its bytes / n (n = 1: off)."""
    old = transport.get_h2d_chunk_bytes()
    transport.set_h2d_chunk_bytes(0 if n == 1 else host.nbytes // n)
    try:
        return transport.stage_h2d(host, dev)
    finally:
        transport.set_h2d_chunk_bytes(old)


def main(argv=None, device=None) -> list:
    """Hold stage_h2d at every N, then measure the four rates.  Returns a
    row per N (MB/s)."""
    ap = S.parser(__doc__, runs=1)
    ap.add_argument("--mb", type=int, default=54)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pieces", type=int, nargs="+", default=list(PIECES))
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    host = np.random.default_rng(0).integers(
        0, 256, args.mb << 20, dtype=np.uint8).reshape(-1, 128)
    want = torch.from_numpy(host)
    for n in args.pieces:
        S.expect(torch.equal(staged(host, n, dev).cpu(), want),
                 f"stage_h2d in {n} pieces differs from the payload")
    print(f"stage_h2d equals the {args.mb} MB payload at N = {args.pieces}")
    if not args.runs:
        return []
    staged(host[:1024], 1, dev)  # the first copy's set-up, untimed
    rows = []
    print(f"payload {args.mb} MB as N pieces (best of {args.reps}), MB/s:")
    print(f"{'N':>5} {'piece':>9} {'pageable':>9} {'pinned':>9} "
          f"{'staged':>9} {'D2H':>9}")
    for n in args.pieces:
        pr = host.shape[0] // n
        pieces = [want[i * pr:(i + 1) * pr] for i in range(n)]
        pinned = [p.pin_memory() for p in pieces]
        mb = n * pr * 128 / (1 << 20)
        devs = [p.to(dev) for p in pieces]
        row = dict(n=n, piece_bytes=pr * 128, mb=mb)
        for name, fn in (
                ("pageable", lambda: [p.to(dev) for p in pieces]),
                ("pinned", lambda: [p.to(dev, non_blocking=True)
                                    for p in pinned]),
                ("staged", lambda: staged(host, n, dev)),
                ("d2h", lambda: [d.cpu() for d in devs])):
            row[name] = mb / _best_s(fn, args.reps)
        rows.append(row)
        print(f"{n:>5} {pr * 128 >> 10:>7}KB {row['pageable']:>9.1f} "
              f"{row['pinned']:>9.1f} {row['staged']:>9.1f} "
              f"{row['d2h']:>9.1f}")
    return rows


if __name__ == "__main__":
    main()
