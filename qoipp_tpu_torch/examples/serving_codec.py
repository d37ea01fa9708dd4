"""Composite serving decode: route streams by size to the right engine.

    python -m qoipp_tpu_torch.examples.serving_codec [--cpu]

The port of the repository's ``examples/serving_codec.py``.  A corpus that
mixes tiny icons with larger images suits no single engine:

  * packed lanes (``models/packed.PackedDecoder``): total work follows the
    sum of the stream sizes, right for the many small streams, but a
    lane's replay is as deep as its bytes, so lanes stay short;
  * length-bucketed batches (``models/scheduler.BucketedCodec``): batches
    of one geometry at tight caps a bucket.

This example routes a mixed corpus through both by hand to show the
mechanics; ``ServingCodec`` (packed tiers, split groups and geometry
buckets behind one front end) is the component to deploy, shown last with
its resident-corpus mode.  Every stream is checked against the native
oracle.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import oracle
from ..common import Channels, Desc
from ..convert import resolve_device
from ..tools import add_device_args

PACK_CAP = 1 << 12  # streams below this pack into shared lanes


def make_corpus(n=24, seed=0):
    """n images cycling through RGBA icons, 96x64 RGB tiles and 128x96 RGB
    photos of a 9-colour palette: [(raw, desc, stream)]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 0:  # tiny icons
            desc = Desc(16 + k % 7, 12, Channels.RGBA)
        elif k % 3 == 1:  # medium tiles
            desc = Desc(96, 64, Channels.RGB)
        else:  # larger photos (one geometry for the bucketed path)
            desc = Desc(128, 96, Channels.RGB)
        npx = desc.width * desc.height
        ch = int(desc.channels)
        pal = rng.integers(0, 256, (9, ch)).astype(np.uint8)
        raw = pal[rng.integers(0, 9, npx)].reshape(-1)
        enc, _ = oracle.encode(raw, desc)
        out.append((raw, desc, enc))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Route a mixed corpus over "
                                "the packed and bucketed engines")
    add_device_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models.packed import PackedDecoder
    from ..models.scheduler import BucketedCodec
    from ..models.serving import ServingCodec

    corpus = make_corpus()
    blobs = [e for _, _, e in corpus]
    descs = [d for _, d, _ in corpus]

    small = [i for i, b in enumerate(blobs) if b.size - 22 <= PACK_CAP]
    large = [i for i in range(len(blobs)) if i not in small]
    print(f"routing: {len(small)} packed, {len(large)} bucketed on {dev}")

    results = [None] * len(blobs)
    if small:
        packer = PackedDecoder(lane_bytes=PACK_CAP, device=dev)
        for i, raw in zip(small, packer.decode([blobs[i] for i in small])):
            results[i] = raw

    # a bucketed codec serves one geometry: group by desc
    by_desc = {}
    for i in large:
        by_desc.setdefault(
            (descs[i].width, descs[i].height, int(descs[i].channels)), []
        ).append(i)
    for idxs in by_desc.values():
        codec = BucketedCodec(descs[idxs[0]], min_len=1 << 12, device=dev)
        imgs = codec.decode([blobs[i] for i in idxs])
        for j, i in enumerate(idxs):
            results[i] = imgs[j].reshape(-1)

    ok = all(np.array_equal(results[i], corpus[i][0])
             for i in range(len(blobs)))
    print("parity vs oracle:", "100%" if ok else "FAILED")

    # the front end to deploy, in its resident-corpus mode: the corpus is
    # staged on the device once, then each request decodes it from there
    serving = ServingCodec(pack_lane_bytes=PACK_CAP, min_len=1 << 12,
                           device=dev)
    resident = serving.make_resident(blobs)
    again = resident.decode()  # request 1
    again2 = resident.decode()  # request 2, no upload
    ok2 = all(np.array_equal(a, corpus[i][0]) and
              np.array_equal(b, corpus[i][0])
              for i, (a, b) in enumerate(zip(again, again2)))
    print("resident-corpus parity (2 requests):", "100%" if ok2 else "FAILED")
    return 0 if (ok and ok2) else 1


if __name__ == "__main__":
    sys.exit(main())
