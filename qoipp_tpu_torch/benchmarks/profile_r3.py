#!/usr/bin/env python
"""Stage profile of BatchPipeline decode and encode on the card.

Counterpart of the repository's ``benchmarks/profile_r3.py``, which timed
every stage of the TPU pipeline's decode (B=128) and encode (a 32-image
sub-batch) to find the next target.  Here each stage runs alone on the
materialized outputs of the one before (stages.time_stages: CUDA-event ms,
device ms and launches by torch.profiler), beside the fused call:

  decode: regions (the stream bytes past the header, zero past each
    stream), boundary (ops/boundary.analyze_region_batch), fields
    (ops/decode.fields_dense_batch), replay (K1), base, place (K2), and
    decode_packed;
  encode, the compact-first stages of the JAX script (the batch
    encoder's reference in kernels/selfcheck; the encoder itself runs
    fields-first): dense (chunk_positions), compact (K3), table
    (chunk_table, the same-hash scan), offsets (chunk_templates: op
    selection, templates, byte offsets), emit (the emit stage's K4 and
    zeroed tail, and the header), and the whole encode_packed_checked.

Regions, boundary, fields, replay and place are the JAX script's stages
as they stand; base is the JAX K2's window_base_rows input
(ops/place_window.window_base_rows), which the port's K2 does without (it
finds each window's rows itself): it is timed, but not part of the stage
sum.  The encode's table and offsets are the port's cut of the JAX
script's table stage and its synthetic-offsets emit stage: the shipped
chain scans inside chunk_templates; here the scan runs alone and its
result goes to chunk_templates (table_val), so the stages compose to the
fused output, the table stage repeating the templates' masks and hash.
The place stage's output must equal decode_packed's and the oracle's
pixels, the emit stage's encode_packed_checked's and the oracle's
streams, or the run fails.  Also printed: the script's chunk statistics.

    python -m qoipp_tpu_torch.benchmarks.profile_r3 [--batch 128] [--encode-batch 32]
    python -m qoipp_tpu_torch.benchmarks.profile_r3 --device cpu --runs 0 --batch 2 --width 64 --height 48
"""

from __future__ import annotations

import numpy as np
import torch

from . import stages as S
from ..kernels import selfcheck
from ..models.pipeline import BatchPipeline
from ..ops import encode as enc_ops
from ..ops import place_window
from ..ops.bitops import pixels_to_packed
from ..utils.corpus import make_corpus

W, H = 1920, 1088  # the script's image size
BATCH, ENCODE_BATCH = 128, 32


def decode_profile(pipe, streams, sizes, want_px, runs: int) -> dict:
    """The decode's stages on (streams, sizes) on the device; want_px the
    oracle's (B, n_px) pixel words.  Returns time_stages' rows and the
    chunk statistics."""
    def regions_of():
        regions = streams[:, 14:]
        q = torch.arange(regions.shape[1], dtype=torch.int32,
                         device=streams.device)[None, :]
        return torch.where(q < (sizes - 14)[:, None], regions, 0)

    regions = regions_of()
    st, info, placed = S.decode_stages(regions, sizes - 22, pipe.n_px,
                                       pipe.qb, pipe.n_cap)
    fused = pipe.decode_packed(streams, sizes)
    S.expect(torch.equal(placed, fused),
             "the decode stages differ from decode_packed")
    S.expect(torch.equal(placed[:, : pipe.n_px], want_px),
             "decode_packed differs from the oracle")
    stages = dict(
        regions=regions_of, boundary=st["boundary"], fields=st["fields"],
        replay=st["replay"],
        base=lambda: place_window.window_base_rows(info["pix_before"],
                                                   pipe.n_cap),
        place=st["place"])
    b = streams.shape[0]
    out = S.time_stages(f"decode B={b}", stages,
                        ("decode_packed",
                         lambda: pipe.decode_packed(streams, sizes)),
                        runs, b * pipe.n_px / 1e6, off_path=("base",))
    tc = info["total_chunks"].cpu().numpy()
    mean_bytes = float(sizes.double().mean()) - 22
    out["chunks"] = dict(min=int(tc.min()), max=int(tc.max()),
                         mean=float(tc.mean()),
                         per_byte=float(tc.mean()) / mean_bytes)
    print(f"[chunks] total_chunks min={tc.min()} max={tc.max()} "
          f"mean={tc.mean():.0f}  bytes(qb)={pipe.qb}  n_px={pipe.n_px} "
          f"chunks/byte={out['chunks']['per_byte']:.3f}")
    return out


def encode_profile(pipe, packed, blobs, runs: int) -> dict:
    """The encode's stages on packed (EB, nb) pixel words on the device;
    blobs the oracle's streams of those images.  Returns time_stages'
    rows and the chunk statistics."""
    n_px, ch = pipe.n_px, pipe.channels
    chunk_cap, out_cap = pipe.chunk_cap, pipe.out_cap
    posflag, keep, fb = selfcheck.chunk_positions(packed, n_px)
    (pk_c, pf_c), counts = enc_ops.compact_rows((packed, posflag), keep,
                                                cap=chunk_cap)
    table = selfcheck.chunk_table(pk_c, pf_c, counts, fb)
    off, tlo, thn, total_len = selfcheck.chunk_templates(
        pk_c, pf_c, counts, n_px, fb, ch, table)

    def emit():
        out = enc_ops.emit_stream(off, tlo, thn, total_len, out_cap)
        out[:, :14] = pipe._header
        return out

    got = emit()
    want, lengths, ok = pipe.encode_packed_checked(packed)
    S.expect(torch.equal(got, want) and torch.equal(total_len, lengths),
             "the encode stages differ from encode_packed_checked")
    S.expect(bool(ok.all()), "encode_packed_checked overflowed its caps")
    host, lens = want.cpu().numpy(), lengths.cpu().numpy()
    S.expect(all(int(n) == b.size and np.array_equal(h[:n], b)
                 for h, n, b in zip(host, lens, blobs)),
             "encode_packed_checked differs from the oracle's streams")
    stages = dict(
        dense=lambda: selfcheck.chunk_positions(packed, n_px),
        compact=lambda: enc_ops.compact_rows((packed, posflag), keep,
                                             cap=chunk_cap),
        table=lambda: selfcheck.chunk_table(pk_c, pf_c, counts, fb),
        offsets=lambda: selfcheck.chunk_templates(
            pk_c, pf_c, counts, n_px, fb, ch, table),
        emit=emit)
    eb = packed.shape[0]
    out = S.time_stages(f"encode B={eb}", stages,
                        ("encode_packed_checked",
                         lambda: pipe.encode_packed_checked(packed)),
                        runs, eb * n_px / 1e6)
    cc = counts.cpu().numpy()
    out["chunks"] = dict(min=int(cc.min()), max=int(cc.max()),
                         mean=float(cc.mean()), chunk_cap=chunk_cap,
                         nb=pipe.nb)
    print(f"[encode chunks] counts min={cc.min()} max={cc.max()} "
          f"mean={cc.mean():.0f} chunk_cap={chunk_cap} nb={pipe.nb}")
    return out


def run(desc, raws, blobs, dev, runs: int, encode_batch: int) -> dict:
    """Both profiles on one corpus (raws and the oracle's blobs of desc):
    decode of every stream, encode of the first encode_batch images."""
    ml = max(b.size for b in blobs)
    pipe = BatchPipeline(desc, max_stream_len=ml, max_encode_len=ml + 4096,
                         device=dev)
    streams, sizes = (torch.from_numpy(x).to(dev)
                      for x in pipe.pack_streams(blobs))
    ch = int(desc.channels)
    raws_d = torch.from_numpy(np.stack(raws)).to(dev)
    want_px = pixels_to_packed(raws_d, ch)
    print(f"qb={pipe.qb} n_cap={pipe.n_cap} stream sizes "
          f"{min(b.size for b in blobs)}..{ml}")
    out = dict(decode=decode_profile(pipe, streams, sizes, want_px, runs))
    eb = min(encode_batch, len(blobs))
    out["encode"] = encode_profile(pipe, pipe.raw_to_packed(raws_d[:eb]),
                                   blobs[:eb], runs)
    return out


def main(argv=None, device=None) -> dict:
    """Make the script's corpus and profile it.  Returns the rows; raises
    if a stage's output differs."""
    ap = S.parser(__doc__)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--encode-batch", type=int, default=ENCODE_BATCH)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    desc, raws, blobs = make_corpus(args.batch, args.width, args.height)
    return run(desc, raws, blobs, dev, args.runs, args.encode_batch)


if __name__ == "__main__":
    main()
