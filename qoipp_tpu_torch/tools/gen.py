"""Noise-image QOI generator: the port of the repository's ``tools/gen.py``
(the reference's 01_gen example).

    python -m qoipp_tpu_torch.tools.gen out.qoi -W 512 -H 512 -C 3

Fills a WxH image with smooth multi-octave value noise (numpy, from
--seed) and encodes it through the port's ``api.encode_into`` on
--backend auto|native|torch (torch on --device, cuda by default).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from .. import api
from ..common import Desc, to_channels, to_string
from . import add_device_args


def value_noise(w, h, octaves=4, seed=0):
    """Smooth multi-octave value noise in [0, 1), shape (h, w)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((h, w), np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = 2 ** (o + 2)
        grid = rng.random((cells + 1, cells + 1))
        ys = np.linspace(0, cells, h, endpoint=False)
        xs = np.linspace(0, cells, w, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        sy = fy * fy * (3 - 2 * fy)
        sx = fx * fx * (3 - 2 * fx)
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        out += amp * ((g00 * (1 - sx) + g01 * sx) * (1 - sy)
                      + (g10 * (1 - sx) + g11 * sx) * sy)
        total += amp
        amp *= 0.5
    return out / total


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a noise QOI image")
    p.add_argument("output", type=Path, help="output .qoi path")
    p.add_argument("-W", "--width", type=int, default=512)
    p.add_argument("-H", "--height", type=int, default=512)
    p.add_argument("-C", "--channels", type=int, default=3, choices=(3, 4))
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--backend", default="auto",
                   choices=("auto", "native", "torch"))
    p.add_argument("-f", "--force", action="store_true", help="overwrite")
    add_device_args(p)
    args = p.parse_args(argv)

    desc = Desc(args.width, args.height, to_channels(args.channels))

    t0 = time.perf_counter()
    planes = [value_noise(args.width, args.height, seed=args.seed * 7 + c)
              for c in range(3)]
    img = np.stack(planes, axis=-1)
    if args.channels == 4:
        alpha = value_noise(args.width, args.height, seed=args.seed * 7 + 5)
        img = np.concatenate([img, alpha[..., None]], axis=-1)
    raw = (img * 255.0).astype(np.uint8).reshape(-1)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = api.encode_into(args.output, raw, desc, overwrite=args.force,
                          backend=args.backend, device=args.device)
    t_enc = time.perf_counter() - t0
    if not res:
        print(f"error: {to_string(res.error())}", file=sys.stderr)
        return 1
    print(f"generated {args.width}x{args.height}x{args.channels} "
          f"-> {args.output} ({res.value()} bytes) "
          f"[gen {t_gen*1e3:.1f} ms, encode {t_enc*1e3:.1f} ms]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
