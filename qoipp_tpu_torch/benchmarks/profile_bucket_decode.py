#!/usr/bin/env python
"""Stage profile of the bucketed batch decode on the real over-cap photos.

Counterpart of the repository's ``benchmarks/profile_bucket_decode.py``:
the committed real corpus's streams of more than ``--cap-kb`` body bytes,
``--replicate`` times each, grouped by geometry (width, height, channels)
as the bucketed engine groups them, one BatchPipeline a group, its batch
padded to a multiple of 8 with header-only streams
(models/scheduler._pad_b).  Per group, the stages regions, boundary,
fields, replay (K1) and place (K2), each alone on the materialized outputs
of the one before (stages.time_stages), beside the fused decode_packed.
The JAX script timed cumulative jitted prefixes (regions and boundary as
one); here every stage is timed alone, and their sum stands beside the
fused call.  The place stage's output must equal decode_packed's, and each
real stream's pixels the oracle's.

    python -m qoipp_tpu_torch.benchmarks.profile_bucket_decode [--replicate 8]
"""

from __future__ import annotations

import numpy as np
import torch

from . import stages as S
from ..models.pipeline import BatchPipeline
from ..models.scheduler import _pad_b
from ..ops.bitops import pixels_to_packed


def groups(corpus, cap: int, replicate: int) -> dict:
    """{(w, h, channels): [(blob, desc, raw)] * replicate} of the streams
    of more than cap body bytes."""
    by_geom = {}
    for _, blob, d, raw in corpus:
        if blob.size - 22 > cap:
            by_geom.setdefault((d.width, d.height, int(d.channels)),
                               []).append((blob, d, raw))
    return {k: v * replicate for k, v in by_geom.items()}


def profile_group(group, dev, runs: int) -> dict:
    """One geometry's stages; returns time_stages' rows."""
    blobs = [b for b, _, _ in group]
    d0 = group[0][1]
    bp = _pad_b(len(blobs))
    pipe = BatchPipeline(d0, max_stream_len=max(b.size for b in blobs),
                         device=dev)
    streams, sizes = (torch.from_numpy(x).to(dev) for x in pipe.pack_streams(
        blobs + [blobs[0][:14]] * (bp - len(blobs))))

    def regions_of():
        regions = streams[:, 14:]
        q = torch.arange(regions.shape[1], dtype=torch.int32,
                         device=dev)[None, :]
        return torch.where(q < (sizes - 14)[:, None], regions, 0)

    stages, _, placed = S.decode_stages(regions_of(), sizes - 22, pipe.n_px,
                                        pipe.qb, pipe.n_cap)
    S.expect(torch.equal(placed, pipe.decode_packed(streams, sizes)),
             f"{d0}: the decode stages differ from decode_packed")
    want = pixels_to_packed(torch.from_numpy(
        np.stack([r for _, _, r in group])).to(dev), int(d0.channels))
    S.expect(torch.equal(placed[: len(blobs), : pipe.n_px], want),
             f"{d0}: decode_packed differs from the oracle")
    label = (f"{d0.width}x{d0.height} ch{int(d0.channels)} B={len(blobs)}"
             f"(pad {bp}) qb={pipe.qb >> 10}K")
    return S.time_stages(label, dict(regions=regions_of, **stages),
                         ("decode_packed",
                          lambda: pipe.decode_packed(streams, sizes)),
                         runs, len(blobs) * pipe.n_px / 1e6)


def main(argv=None, device=None) -> dict:
    """Profile every geometry group of the real corpus's over-cap streams.
    Returns {geometry: rows}; raises if a stage's output differs."""
    ap = S.parser(__doc__)
    ap.add_argument("--replicate", type=int, default=8)
    ap.add_argument("--cap-kb", type=int, default=256)
    ap.add_argument("--corpus", default=str(S.CORPUS_DIR))
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    by_geom = groups(S.real_corpus(args.corpus), args.cap_kb << 10,
                     args.replicate)
    n = sum(len(g) for g in by_geom.values())
    print(f"{n // args.replicate} over-cap images x{args.replicate}, "
          f"{len(by_geom)} geometries")
    return {"x".join(map(str, k)): profile_group(g, dev, args.runs)
            for k, g in by_geom.items()}


if __name__ == "__main__":
    main()
