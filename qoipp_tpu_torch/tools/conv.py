"""PNG <-> QOI converter: the port of the repository's ``tools/conv.py``
(the reference's 02_conv example).

    python -m qoipp_tpu_torch.tools.conv in.png out.qoi [--rgb-only]
    python -m qoipp_tpu_torch.tools.conv in.qoi out.png

The direction comes from the extensions; the QOI side runs through the
port's api on --backend auto|native|torch (torch on --device, cuda by
default).  PNG input and output need Pillow, imported only here.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from .. import api
from ..common import Channels, Desc, Image, to_string
from . import add_device_args


def load_png(path, rgb_only):
    from PIL import Image as PILImage

    im = PILImage.open(path)
    if im.mode not in ("RGB", "RGBA"):
        im = im.convert("RGBA" if ("A" in im.mode or im.mode == "P")
                        else "RGB")
    if rgb_only and im.mode == "RGBA":
        im = im.convert("RGB")
    arr = np.asarray(im, dtype=np.uint8)
    ch = Channels.RGBA if arr.shape[-1] == 4 else Channels.RGB
    return arr.reshape(-1), Desc(arr.shape[1], arr.shape[0], ch)


def save_png(path, img: Image):
    from PIL import Image as PILImage

    mode = "RGBA" if img.desc.channels == Channels.RGBA else "RGB"
    arr = img.data.reshape(img.desc.height, img.desc.width,
                           int(img.desc.channels))
    PILImage.fromarray(arr, mode).save(path)


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert PNG<->QOI")
    p.add_argument("input", type=Path)
    p.add_argument("output", type=Path)
    p.add_argument("--rgb-only", action="store_true",
                   help="drop alpha when converting PNG->QOI")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "native", "torch"))
    p.add_argument("-f", "--force", action="store_true", help="overwrite")
    add_device_args(p)
    args = p.parse_args(argv)

    src, dst = args.input.suffix.lower(), args.output.suffix.lower()
    if not args.input.exists():
        print(f"error: {args.input} does not exist", file=sys.stderr)
        return 1

    if src == ".png" and dst == ".qoi":
        t0 = time.perf_counter()
        raw, desc = load_png(args.input, args.rgb_only)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = api.encode_into(args.output, raw, desc, overwrite=args.force,
                              backend=args.backend, device=args.device)
        t_enc = time.perf_counter() - t0
        if not res:
            print(f"error: {to_string(res.error())}", file=sys.stderr)
            return 1
        print(f"{args.input} ({desc.width}x{desc.height}x"
              f"{int(desc.channels)}) -> {args.output} ({res.value()} bytes) "
              f"[load {t_load*1e3:.1f} ms, encode {t_enc*1e3:.1f} ms]")
    elif src == ".qoi" and dst == ".png":
        t0 = time.perf_counter()
        res = api.decode(args.input, backend=args.backend,
                         device=args.device)
        t_dec = time.perf_counter() - t0
        if not res:
            print(f"error: {to_string(res.error())}", file=sys.stderr)
            return 1
        if args.output.exists() and not args.force:
            print(f"error: {args.output} exists (use -f)", file=sys.stderr)
            return 1
        t0 = time.perf_counter()
        save_png(args.output, res.value())
        t_save = time.perf_counter() - t0
        d = res.value().desc
        print(f"{args.input} -> {args.output} "
              f"({d.width}x{d.height}x{int(d.channels)}) "
              f"[decode {t_dec*1e3:.1f} ms, save {t_save*1e3:.1f} ms]")
    else:
        print("error: need .png->.qoi or .qoi->.png", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
