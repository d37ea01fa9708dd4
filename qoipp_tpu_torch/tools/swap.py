"""Channel rotation: the port of the repository's ``tools/swap.py`` (the
reference's 03_swap example).  Decodes a QOI image, rotates its colour
channels (r -> g -> b -> r, --rotations times) and encodes it again, in
place or to -o.

    python -m qoipp_tpu_torch.tools.swap image.qoi -n 1 [-o out.qoi]

--generator-api re-encodes through the per-pixel generator callback
(native, slow); otherwise the rotated buffer goes through the port's api
on --backend auto|native|torch (torch on --device, cuda by default).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from .. import api
from ..common import Pixel, to_string
from . import add_device_args


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Rotate QOI color channels (r->g->b->r)")
    p.add_argument("input", type=Path)
    p.add_argument("-o", "--output", type=Path, default=None,
                   help="output path (default: in place)")
    p.add_argument("-n", "--rotations", type=int, default=1)
    p.add_argument("--generator-api", action="store_true",
                   help="re-encode through the pixel-generator callback")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "native", "torch"))
    add_device_args(p)
    args = p.parse_args(argv)

    out = args.output or args.input
    t0 = time.perf_counter()
    res = api.decode(args.input, backend=args.backend, device=args.device)
    if not res:
        print(f"error: {to_string(res.error())}", file=sys.stderr)
        return 1
    img = res.value()
    ch = int(img.desc.channels)
    px = img.data.reshape(-1, ch)

    r = args.rotations % 3
    order = np.roll(np.arange(3), r)
    if ch == 4:
        order = np.concatenate([order, [3]])
    rotated = px[:, order]

    if args.generator_api:
        def gen(i):
            row = rotated[i]
            return Pixel(int(row[0]), int(row[1]), int(row[2]),
                         int(row[3]) if ch == 4 else 0xFF)

        enc = api.encode(gen, img.desc, backend="native")
    else:
        enc = api.encode(rotated.reshape(-1), img.desc, backend=args.backend,
                         device=args.device)
    if not enc:
        print(f"error: {to_string(enc.error())}", file=sys.stderr)
        return 1
    out.write_bytes(enc.value().tobytes())
    print(f"{args.input} -> {out}: rotated {r}x "
          f"({img.desc.width}x{img.desc.height}x{ch}) "
          f"[{(time.perf_counter()-t0)*1e3:.1f} ms]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
