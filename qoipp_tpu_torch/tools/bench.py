"""Multi-codec QOI benchmark of the port.

    python -m qoipp_tpu_torch.tools.bench tests/resources/local_corpus
    python -m qoipp_tpu_torch.tools.bench --synthetic 16 --width 1920 \\
        --height 1088                      # uniform: adds torch-batch
    python -m qoipp_tpu_torch.tools.bench --sizes   # one-shot routing sweep

The counterpart of the repository's ``tools/bench.py`` (the reference's
04_bench): the enc x dec cross matrix of every QOI codec checked against
the raw pixels before any timing, then per-image and TOTAL rows of encode
and decode ms, MPix/s, the change against native, the encoded size and
the ratio; 1 cold, 3 warmup (none with --no-warmup) and --runs timed calls
a cell, the host clock around whole calls (``utils/timing.time_ms``), every
device call waited for with ``torch.cuda.synchronize()``.

Codecs:
  native       the C++ reference codec on the host (the oracle)
  torch        the one-shot device codec (api backend "torch")
  stream       the host streaming codec with a 64 KiB buffer
  png          Pillow's PNG (skipped where Pillow is missing)
  torch-batch  BatchPipeline over the whole corpus at once (uniform
               geometry only), inputs already on the device
  serving      ServingCodec (packed tiers, split groups, geometry buckets);
               decode timed to completion on the device

``--sizes`` instead times one image at each size through the api, native
against torch, decode and encode, cold (the first call) and warm (the best
of three): where a one-shot call on the card starts to win.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import api, oracle
from ..common import Channels, Desc
from ..convert import resolve_device
from ..stream import StreamDecoder, StreamEncoder
from ..utils.timing import mpix_per_s, time_ms
from . import add_device_args

CODECS = ("native", "torch", "torch-batch", "stream", "png", "serving")
SIZES = "512x512,1920x1080,3840x2160"  # benchmarks/routing_oneshot.py's


def load_corpus(args):
    """[(name, raw, desc)]: --synthetic images, or the .qoi (and, with
    Pillow, .png) files under args.corpus."""
    images = []
    if args.synthetic:
        rng = np.random.default_rng(0)
        for i in range(args.synthetic):
            w, h = args.width, args.height
            base = rng.integers(0, 256, (24, 3)).astype(np.uint8)
            ids = rng.integers(0, 24, w * h)
            ids = np.maximum.accumulate(
                np.where(rng.random(w * h) < 0.03, ids, 0)) % 24
            raw = base[ids].reshape(-1)
            images.append((f"synthetic_{i}", raw, Desc(w, h, Channels.RGB)))
        return images

    for path in sorted(Path(args.corpus).rglob("*")):
        if path.suffix.lower() == ".qoi":
            img = api.decode(path, backend="native")
            if img:
                images.append((path.name, img.value().data,
                               img.value().desc))
        elif path.suffix.lower() == ".png":
            try:
                from PIL import Image as PILImage
            except ImportError:
                continue
            im = PILImage.open(path)
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
            arr = np.asarray(im, np.uint8)
            ch = Channels.RGBA if arr.shape[-1] == 4 else Channels.RGB
            images.append((path.name, arr.reshape(-1),
                           Desc(arr.shape[1], arr.shape[0], ch)))
    return images


def drive_stream_encode(raw, desc, buf=65536, feed=None):
    """raw pixels -> the whole QOI stream through StreamEncoder: ``buf``
    bytes of output a call, at most ``feed`` input bytes a call (None: all
    that is left)."""
    enc = StreamEncoder()
    out = np.zeros(buf, np.uint8)
    hdr = np.zeros(14, np.uint8)
    enc.initialize(hdr, desc)
    parts = bytearray(hdr.tobytes())
    consumed = 0
    while consumed < raw.size:
        stop = raw.size if feed is None else consumed + feed
        r = enc.encode(out, raw[consumed:stop]).value()
        parts += out[: r.written].tobytes()
        consumed += r.processed
    fin = np.zeros(9, np.uint8)
    n = enc.finalize(fin).value()
    parts += fin[:n].tobytes()
    return np.frombuffer(bytes(parts), np.uint8)


def drive_stream_decode(blob, desc, buf=65536, feed=None):
    """A QOI stream -> its pixels through StreamDecoder: ``buf`` bytes of
    output a call, at most ``feed`` stream bytes a call (None: all that
    is left before the end marker; a ``feed`` window may run into it),
    then the pending run drained."""
    dec = StreamDecoder()
    dec.initialize(blob[:14])
    out = np.zeros(buf, np.uint8)
    parts = bytearray()
    consumed = 14
    end = blob.size - 8
    while consumed < end:
        stop = end if feed is None else consumed + feed
        r = dec.decode(out, blob[consumed:stop]).value()
        parts += out[: r.written].tobytes()
        consumed += r.processed
        if r.processed == 0 and r.written == 0:
            break
    while dec.has_run_count():
        n = dec.drain_run(out).value()
        parts += out[:n].tobytes()
    dec.reset()
    return np.frombuffer(bytes(parts), np.uint8)


def fmt_row(cols):
    return "  ".join(f"{c:>12}" for c in cols)


def _synced(fn, dev):
    """fn, then a wait for the card where dev is one: a call's time is
    its work's."""
    def call():
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out
    return call


def timed(fn, runs, warmup):
    """Seconds a call: 1 cold call, then time_ms over warmup and runs."""
    fn()
    return time_ms(fn, runs=runs, warmup=warmup) / 1e3


def _total_row(codec, te, td, n_total):
    """A TOTAL row of encode and decode seconds over n_total pixels; a
    direction not timed (nan or 0) shows "-"."""
    def ms(t):
        return f"{t*1e3:.2f}" if t == t and t > 0 else "-"

    def rate(t):
        return f"{n_total/t/1e6:.1f}" if t == t and t > 0 else "-"

    return fmt_row(["TOTAL", codec, ms(te), ms(td), rate(te), rate(td),
                    "-", "-", "-", "-"])


def verify_cross_matrix(images, qoi_codecs, dev):
    """Every codec's stream equals native's, and every codec's decoder
    gives the raw pixels back from every codec's stream."""
    def enc_with(c, raw, desc):
        if c == "native":
            out, complete = oracle.encode(raw, desc)
            if not complete:
                raise AssertionError("the oracle stopped short")
            return out
        if c == "torch":
            return api.encode(raw, desc, backend="torch", device=dev).value()
        return drive_stream_encode(raw, desc)

    def dec_with(c, blob, desc):
        if c == "native":
            return oracle.decode(blob, desc, desc.channels)
        if c == "torch":
            return api.decode(blob, backend="torch",
                              device=dev).value().data
        return drive_stream_decode(blob, desc)

    for name, raw, desc in images:
        encs = {c: enc_with(c, raw, desc) for c in qoi_codecs}
        want = encs.get("native", next(iter(encs.values())))
        for ce, blob in encs.items():
            if not np.array_equal(blob, want):
                raise AssertionError(
                    f"{ce} encode bytes differ from native on {name}")
            for cd in qoi_codecs:
                if not np.array_equal(dec_with(cd, blob, desc), raw):
                    raise AssertionError(f"cross roundtrip {ce}->enc->{cd}"
                                         f"->dec mismatch on {name}")
    print(f"verification: {len(qoi_codecs)}x{len(qoi_codecs)} enc/dec "
          "cross matrix bit-exact on every image")


def _image_times(c, raw, desc, blob, args, warmup, dev):
    """(encode s, decode s, size in bytes) of one codec on one image."""
    te = td = float("nan")
    size_b = blob.size
    if c == "png":
        import io

        from PIL import Image as PILImage

        mode = "RGBA" if desc.channels == Channels.RGBA else "RGB"
        arr2d = raw.reshape(desc.height, desc.width, int(desc.channels))

        def png_enc():
            bio = io.BytesIO()
            PILImage.fromarray(arr2d, mode).save(bio, format="PNG")
            return bio.getvalue()

        png_blob = png_enc()
        size_b = len(png_blob)
        enc = png_enc

        def dec():
            return np.asarray(PILImage.open(io.BytesIO(png_blob)))
    elif c == "native":
        def enc():
            return oracle.encode(raw, desc)

        def dec():
            return oracle.decode(blob, desc, desc.channels)
    elif c == "torch":
        enc = _synced(lambda: api.encode(raw, desc, backend="torch",
                                         device=dev), dev)
        dec = _synced(lambda: api.decode(blob, backend="torch", device=dev),
                      dev)
    else:
        def enc():
            return drive_stream_encode(raw, desc)

        def dec():
            return drive_stream_decode(blob, desc)
    if not args.no_encode:
        te = timed(enc, args.runs, warmup)
    if not args.no_decode:
        td = timed(dec, args.runs, warmup)
    return te, td, size_b


def bench_batch(images, args, warmup, dev):
    """The torch-batch TOTAL row: BatchPipeline over the whole corpus,
    streams and packed pixels on the device before timing."""
    from ..models.pipeline import BatchPipeline

    _, _, desc0 = images[0]
    raws = [r for _, r, _ in images]
    blobs = [oracle.encode(r, d)[0] for _, r, d in images]
    pipe = BatchPipeline(desc0, max_stream_len=max(b.size for b in blobs),
                         max_encode_len=max(b.size for b in blobs) + 1024,
                         device=dev)
    streams, sizes = (torch.from_numpy(x).to(dev)
                      for x in pipe.pack_streams(blobs))
    packed_in = pipe.raw_to_packed(np.stack(raws))
    n_total = sum(d.width * d.height for _, _, d in images)
    if not args.no_verify:
        got = pipe.decode(streams, sizes).reshape(len(raws), -1).cpu()
        out, lens, ok = pipe.encode_packed_checked(packed_in)
        out, lens = out.cpu().numpy(), lens.cpu().numpy()
        for i, (raw, blob) in enumerate(zip(raws, blobs)):
            if not (np.array_equal(got[i].numpy(), raw) and bool(ok[i])
                    and np.array_equal(out[i, : lens[i]], blob)):
                raise AssertionError(f"torch-batch differs from native on "
                                     f"{images[i][0]}")
        print(f"verification: torch-batch decode and encode bit-exact on "
              f"{len(raws)} images")
    td = te = float("nan")
    if not args.no_decode:
        td = timed(_synced(lambda: pipe.decode_packed(streams, sizes), dev),
                   args.runs, warmup)
    if not args.no_encode:
        te = timed(_synced(lambda: pipe.encode_packed_checked(packed_in),
                           dev), args.runs, warmup)
    print(_total_row("torch-batch", te, td, n_total))


def bench_serving(images, args, warmup, dev):
    """The serving TOTAL row: ServingCodec at its defaults, decode to
    completion on the device, encode to host streams."""
    from ..models.serving import ServingCodec

    codec = ServingCodec(device=dev)
    raws = [r for _, r, _ in images]
    descs = [d for _, _, d in images]
    blobs = [oracle.encode(r, d)[0] for r, d in zip(raws, descs)]
    n_total = sum(d.width * d.height for d in descs)
    if not args.no_verify:
        for (name, raw, _), got, stream, blob in zip(
                images, codec.decode(blobs), codec.encode(raws, descs),
                blobs):
            if not (np.array_equal(got, raw) and np.array_equal(stream, blob)):
                raise AssertionError(f"serving differs from native on {name}")
        print("verification: serving decode and encode bit-exact on every "
              "image")
    td = te = float("nan")
    if not args.no_decode:
        td = timed(_synced(lambda: codec.decode_dispatch(blobs), dev),
                   args.runs, warmup)
    if not args.no_encode:
        te = timed(lambda: codec.encode(raws, descs), args.runs, warmup)
    print(_total_row("serving", te, td, n_total))


def sweep_oneshot(sizes, dev):
    """One image at each WxH through api.decode and api.encode, native
    against torch: cold (the first call at that size) and warm (best of
    3), ms; torch/native above 1 means native is faster."""
    from ..utils.corpus import make_corpus

    print(fmt_row(["size", "backend", "dec warm", "dec cold", "enc warm",
                   "enc cold", "dec MP/s", "enc MP/s"]))
    for size in sizes.split(","):
        w, h = (int(x) for x in size.lower().split("x"))
        desc, raws, blobs = make_corpus(1, w, h, seed=11)
        raw, blob = raws[0], blobs[0]
        rows = {}
        for be in ("native", "torch"):
            dev_arg = dev if be == "torch" else None

            def dec():
                r = api.decode(blob, backend=be, device=dev_arg)
                if not (r and np.array_equal(r.value().data, raw)):
                    raise AssertionError(f"{be} decode differs at {size}")

            def enc():
                r = api.encode(raw, desc, backend=be, device=dev_arg)
                if not (r and np.array_equal(r.value(), blob)):
                    raise AssertionError(f"{be} encode differs at {size}")

            t = {}
            for what, fn in (("dec", dec), ("enc", enc)):
                t0 = time.perf_counter()
                fn()
                t[f"{what} cold"] = (time.perf_counter() - t0) * 1e3
                t[f"{what} warm"] = min(time_ms(fn, runs=1, warmup=0)
                                        for _ in range(3))
            rows[be] = t
            print(fmt_row([size, be] + [f"{t[k]:.2f}" for k in (
                "dec warm", "dec cold", "enc warm", "enc cold")] + [
                f"{mpix_per_s(w * h, t['dec warm']):.1f}",
                f"{mpix_per_s(w * h, t['enc warm']):.1f}"]))
        n, d = rows["native"], rows["torch"]
        print(f"{size}: torch/native warm: decode "
              f"{d['dec warm'] / n['dec warm']:.2f}x, encode "
              f"{d['enc warm'] / n['enc warm']:.2f}x (>1: native faster)")


def main(argv=None):
    p = argparse.ArgumentParser(description="QOI codec benchmark")
    p.add_argument("corpus", nargs="?", default=None,
                   help="directory of .qoi/.png images")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic images instead")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--no-encode", action="store_true")
    p.add_argument("--no-decode", action="store_true")
    p.add_argument("--only-totals", action="store_true")
    for c in CODECS:
        p.add_argument(f"--no-{c}", action="store_true")
    p.add_argument("--sizes", nargs="?", const=SIZES, default=None,
                   help="time the one-shot api at these WxH sizes instead "
                        f"(default {SIZES})")
    add_device_args(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev)}"
          if dev.type == "cuda" else f"device: {dev}")
    if args.sizes:
        sweep_oneshot(args.sizes, dev)
        return 0
    if not args.corpus and not args.synthetic:
        args.synthetic = 4

    images = load_corpus(args)
    if not images:
        print("no images found", file=sys.stderr)
        return 1
    warmup = 0 if args.no_warmup else 3

    codecs = [c for c in ("native", "torch", "stream", "png")
              if not getattr(args, f"no_{c}")]
    try:
        import PIL  # noqa: F401
    except ImportError:
        codecs = [c for c in codecs if c != "png"]

    if not args.no_verify:
        verify_cross_matrix(images, [c for c in codecs if c != "png"], dev)

    if not args.only_totals:
        print(fmt_row(["image", "codec", "enc ms", "dec ms", "enc MP/s",
                       "dec MP/s", "enc d%", "dec d%", "size KiB",
                       "ratio %"]))
    totals = {}
    for name, raw, desc in images:
        n_px = desc.width * desc.height
        blob, _ = oracle.encode(raw, desc)
        base_te = base_td = None
        for c in codecs:
            te, td, size_b = _image_times(c, raw, desc, blob, args, warmup,
                                          dev)
            if c == "native":
                base_te, base_td = te, td

            def delta(x, base):
                if x != x or not base or base != base:
                    return "-"
                return f"{100*(x-base)/base:+.0f}%"

            if not args.only_totals:
                print(fmt_row([
                    name[:12], c, f"{te*1e3:.2f}", f"{td*1e3:.2f}",
                    f"{n_px/te/1e6:.1f}" if te == te else "-",
                    f"{n_px/td/1e6:.1f}" if td == td else "-",
                    delta(te, base_te), delta(td, base_td),
                    f"{size_b/1024:.1f}", f"{100*size_b/raw.size:.1f}"]))
            acc = totals.setdefault(c, [0.0, 0.0, 0])
            acc[0] += te if te == te else 0
            acc[1] += td if td == td else 0
            acc[2] += n_px

    if not args.no_torch_batch and len({
            (d.width, d.height, d.channels) for _, _, d in images}) == 1:
        bench_batch(images, args, warmup, dev)
    if not args.no_serving:
        bench_serving(images, args, warmup, dev)

    for c, (te, td, npx) in totals.items():
        print(_total_row(c, te, td, npx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
