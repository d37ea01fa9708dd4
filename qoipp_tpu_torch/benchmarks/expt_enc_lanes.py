#!/usr/bin/env python
"""The packed encoder's lane-count sweep on the card.

Counterpart of the repository's ``benchmarks/expt_enc_lanes.py``, which
measured on the TPU how the packed encoder's device time grows with the
lane count, to calibrate the plan search's cost model.  The corpus is the
committed real corpus's images of at most 2^19 - 2 pixels, ``--replicate``
times each; for each L of ``--lanes``, PackedEncoder(lane_px=2^19,
lane_counts=[L]) plans and uploads them, and
ops/encode._encode_lanes_impl runs at the plan's caps (again at its safe
caps where a lane's checked flag trips: the retry flag).  The streams
PackedEncoder.finish makes must equal the oracle's before the call is
timed: CUDA-event ms, device ms and launches (torch.profiler), the lane
grid's use (pixels over lanes x slots) and MPix/s.

    python -m qoipp_tpu_torch.benchmarks.expt_enc_lanes [--lanes 8 12 16 24 32 48 64]
"""

from __future__ import annotations

from . import stages as S
from .profile_packed_encode import check_streams, lane_corpus
from ..models import packed
from ..ops import encode as enc_ops

LANES = (8, 12, 16, 24, 32, 48, 64)
LANE_PX = 512 << 10


def sweep_one(lanes: int, raws, descs, want, dev, runs: int,
              lane_px: int = LANE_PX) -> dict:
    """One lane count: plan, hold against the oracle, time."""
    total_px = sum(d.width * d.height for d in descs)
    enc = packed.PackedEncoder(lane_px=lane_px, lane_counts=[lanes],
                               device=dev)
    staged = enc.stage_to_device(raws, descs)
    pd, fd, where, caps, _ = staged

    def run(chunk_cap, out_cap):
        return enc_ops._encode_lanes_impl(pd, fd, chunk_cap, out_cap,
                                          caps["ends_cap"])

    first = run(caps["chunk_cap"], caps["out_cap"])
    retried = not bool(first[3].all())
    cc, oc = ((caps["safe_chunk"], caps["safe_out"]) if retried
              else (caps["chunk_cap"], caps["out_cap"]))
    check_streams(enc, (*run(cc, oc), staged), where, descs, want,
                  f"L={lanes}")
    l, np_ = pd.shape
    row = dict(lanes=l, np=np_, chunk_cap=cc, retry=retried,
               util=total_px / (l * np_), **S.measure(lambda: run(cc, oc),
                                                      runs))
    print(f"L={l:3d} np={np_ >> 10:5d}K ccap={cc >> 10:4d}K "
          f"util={row['util']:.2f} {'RETRY ' if retried else ''}"
          + (f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
             f"{row['launches']:g} launches "
             f"({total_px / row['ms'] / 1e3:.0f} MPix/s)" if runs
             else "equal to the oracle"))
    return row


def main(argv=None, device=None) -> list:
    """The sweep.  Returns a row per lane count; raises if a stream
    differs from the oracle's."""
    ap = S.parser(__doc__)
    ap.add_argument("--lanes", type=int, nargs="+", default=list(LANES))
    ap.add_argument("--replicate", type=int, default=4)
    ap.add_argument("--lane-px", type=int, default=LANE_PX)
    ap.add_argument("--corpus", default=str(S.CORPUS_DIR))
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    raws, descs, want = lane_corpus(args.corpus, args.lane_px,
                                    args.replicate)
    print(f"corpus: {len(raws)} streams, "
          f"{sum(d.width * d.height for d in descs) / 1e6:.1f} MPix")
    return [sweep_one(n, raws, descs, want, dev, args.runs, args.lane_px)
            for n in args.lanes]


if __name__ == "__main__":
    main()
