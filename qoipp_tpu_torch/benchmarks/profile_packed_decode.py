#!/usr/bin/env python
"""Stage profile of the packed-lane decoder at the real-corpus shapes.

Counterpart of the repository's ``benchmarks/profile_packed_decode.py``:
the committed real corpus's streams of at most ``--lane-kb`` body bytes,
``--replicate`` times each, planned by PackedDecoder(lane_bytes) and
uploaded by its stage_plan.  Stages, each alone on the materialized
outputs of the one before (stages.time_stages): regions (the nonempty
lanes padded to the lane grid), boundary, fields (with each stream's
reset flag), replay (K1) and place (K2), beside the fused
packed._decode_lanes.  The JAX script timed cumulative jitted prefixes
from boundary on, its lanes padded on the host; here the padding is the
regions stage, as packed.lane_inputs pads on the device.  The place
stage's output must equal _decode_lanes', and every stream's pixels the
oracle's.

    python -m qoipp_tpu_torch.benchmarks.profile_packed_decode [--replicate 8] [--lane-kb 256]
"""

from __future__ import annotations

import torch

from . import stages as S
from ..models import packed
from ..ops.bitops import pixels_to_packed


def main(argv=None, device=None) -> dict:
    """Profile the packed decoder's stages.  Returns time_stages' rows;
    raises if a stage's output differs."""
    ap = S.parser(__doc__)
    ap.add_argument("--replicate", type=int, default=8)
    ap.add_argument("--lane-kb", type=int, default=256)
    ap.add_argument("--corpus", default=str(S.CORPUS_DIR))
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    cap = args.lane_kb << 10
    items = [(b, d, r) for _, b, d, r in S.real_corpus(args.corpus)
             if b.size - 22 <= cap] * args.replicate
    total_px = sum(d.width * d.height for _, d, _ in items)
    dec = packed.PackedDecoder(lane_bytes=cap, device=dev)
    plan = dec.plan_and_pack([b for b, _, _ in items])
    regions, seg, sizes, where, _, qb, n_cap, l_total = dec.stage_plan(plan)
    print(f"{len(items)} streams, {l_total} lanes ({regions.shape[0]} "
          f"uploaded) x {qb >> 10} KB, n_cap {n_cap >> 10} Kpx, "
          f"{total_px / 1e6:.1f} MPix")

    def regions_of():
        return torch.nn.functional.pad(
            regions, (0, 0, 0, l_total - regions.shape[0]))

    def resets():
        flags = torch.zeros(l_total * qb, dtype=torch.int32, device=dev)
        flags[seg] = 1
        return flags.view(l_total, qb)

    stages, _, placed = S.decode_stages(regions_of(), sizes, 0, qb, n_cap,
                                        resets=resets)

    def fused():
        return packed._decode_lanes(regions, seg, sizes, qb=qb, n_cap=n_cap,
                                    l_total=l_total)

    S.expect(torch.equal(placed, fused()),
             "the decode stages differ from _decode_lanes")
    for (lane, poff), (_, d, raw) in zip(where, items):
        npx = d.width * d.height
        want = pixels_to_packed(torch.from_numpy(raw).to(dev),
                                int(d.channels))
        S.expect(torch.equal(placed[lane, poff: poff + npx], want),
                 f"lane {lane} at {poff}: pixels differ from the oracle")
    return S.time_stages(f"packed decode {len(items)} streams",
                         dict(regions=regions_of, **stages),
                         ("_decode_lanes", fused), args.runs,
                         total_px / 1e6)


if __name__ == "__main__":
    main()
