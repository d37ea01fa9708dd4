#!/usr/bin/env python
"""Stage profile of the packed-lane encoder at the real-corpus shapes.

Counterpart of the repository's ``benchmarks/profile_packed_encode.py``:
the committed real corpus's images of at most ``--lane-px`` - 2 pixels,
``--replicate`` times each, planned by PackedEncoder(lane_px) and
uploaded by its stage_plan.  Stages of ops/encode._encode_lanes_impl,
each alone on the materialized outputs of the one before
(stages.time_stages): dense (lane_positions), compact (K3), table
(lane_table, the segmented same-hash scan), templates (lane_templates),
ends (the one-plane K3 of each stream's end) and emit (the emit stage's
K4 and zeroed tail, and the ok flags), beside the fused
_encode_lanes_impl.  The JAX script timed cumulative jitted prefixes
(dense, compact, table, full); here the stages past table are the port's
own cut of its full call (the table's result handed to lane_templates,
which the shipped call leaves to scan inline), so that they compose to
its output.  The emit stage's outputs must equal _encode_lanes_impl's,
and the streams PackedEncoder.finish makes of them the oracle's.

    python -m qoipp_tpu_torch.benchmarks.profile_packed_encode [--replicate 4]
"""

from __future__ import annotations

import torch

from . import stages as S
from ..models import packed
from ..ops import encode as enc_ops


def lane_corpus(corpus_dir, lane_px: int, replicate: int):
    """(raws, descs, the oracle's streams) of the corpus's images of at
    most lane_px - 2 pixels, each replicate times."""
    items = [(r, d, b) for _, b, d, r in S.real_corpus(corpus_dir)
             if d.width * d.height <= lane_px - 2] * replicate
    return ([r for r, _, _ in items], [d for _, d, _ in items],
            [b for _, _, b in items])


def check_streams(enc, dispatched, where, descs, want, what: str) -> None:
    """PackedEncoder.finish of a dispatched encode against the oracle's
    streams (finish encodes again at the safe caps where a lane's flag
    tripped)."""
    out, ends, nseg, ok, staged = dispatched
    got = enc.finish((out, ends, nseg, ok, staged, where, descs))
    S.expect(len(got) == len(want) and all(
        g.size == w.size and (g == w).all() for g, w in zip(got, want)),
        f"{what}: the streams differ from the oracle's")


def main(argv=None, device=None) -> dict:
    """Profile the packed encoder's stages.  Returns time_stages' rows;
    raises if a stage's output differs."""
    ap = S.parser(__doc__)
    ap.add_argument("--replicate", type=int, default=4)
    ap.add_argument("--lane-px", type=int, default=512 << 10)
    ap.add_argument("--corpus", default=str(S.CORPUS_DIR))
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    raws, descs, want = lane_corpus(args.corpus, args.lane_px,
                                    args.replicate)
    total_px = sum(d.width * d.height for d in descs)
    enc = packed.PackedEncoder(lane_px=args.lane_px, device=dev)
    staged = enc.stage_to_device(raws, descs)
    packed_d, flags_d, where, caps, _ = staged
    chunk_cap, out_cap, ends_cap = (caps[k] for k in
                                    ("chunk_cap", "out_cap", "ends_cap"))
    print(f"{len(raws)} images over {packed_d.shape[0]} lanes x "
          f"{packed_d.shape[1] >> 10} Kpx, chunk_cap {chunk_cap >> 10}K, "
          f"out_cap {out_cap >> 10}K, {total_px / 1e6:.1f} MPix")

    pk_aug, posflag, keep, bits = enc_ops.lane_positions(packed_d, flags_d)
    (pk_c, pf_c), counts = enc_ops.compact_rows((pk_aug, posflag), keep,
                                                cap=chunk_cap)
    table = enc_ops.lane_table(pk_c, pf_c, counts, bits)
    off, tlo, thn, incl, t1, total_len = enc_ops.lane_templates(
        pk_c, pf_c, counts, bits, table)
    cols = torch.arange(ends_cap, dtype=torch.int32, device=dev)[None, :]

    def ends_of():
        (ends,), nseg = enc_ops.compact_rows((incl,), t1, cap=ends_cap)
        return torch.where(cols < nseg[:, None], ends, 0), nseg

    def emit():
        return (enc_ops.emit_stream(off, tlo, thn, total_len, out_cap),
                enc_ops.caps_ok(counts, chunk_cap, total_len, out_cap))

    ends, nseg = ends_of()
    out, ok = emit()
    fused = (lambda: enc_ops._encode_lanes_impl(packed_d, flags_d, chunk_cap,
                                                out_cap, ends_cap))
    S.expect(all(torch.equal(a, b) for a, b in zip((out, ends, nseg, ok),
                                                   fused())),
             "the encode stages differ from _encode_lanes_impl")
    check_streams(enc, (out, ends, nseg, ok, staged), where, descs, want,
                  "the packed encode stages")
    stages = dict(
        dense=lambda: enc_ops.lane_positions(packed_d, flags_d),
        compact=lambda: enc_ops.compact_rows((pk_aug, posflag), keep,
                                             cap=chunk_cap),
        table=lambda: enc_ops.lane_table(pk_c, pf_c, counts, bits),
        templates=lambda: enc_ops.lane_templates(pk_c, pf_c, counts, bits,
                                                 table),
        ends=ends_of, emit=emit)
    res = S.time_stages(f"packed encode {len(raws)} images", stages,
                        ("_encode_lanes_impl", fused), args.runs,
                        total_px / 1e6)
    res["retry"] = not bool(ok.all())
    return res


if __name__ == "__main__":
    main()
