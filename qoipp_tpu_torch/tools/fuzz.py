"""Differential fuzzer of the port.

    python -m qoipp_tpu_torch.tools.fuzz -n 50 -s 0      # on the card
    python -m qoipp_tpu_torch.tools.fuzz --cpu -n 2      # plain versions

The counterpart of the repository's ``tools/fuzz.py``, with the same eight
targets, generators and flags.  Every target feeds inputs drawn from one
seeded generator through a codec of the port and compares the result with
the native oracle byte for byte:

- ``decode``: random chunk payloads behind a valid header through the
  one-shot device decoder (``ops/backend``);
- ``truncated``: well-formed streams cut short, through the same decoder
  and through ``api.decode(backend="torch")`` against the native backend;
- ``encode``: random raw buffers through ``api.encode(backend="torch")``
  and the scatter oracle ``ops/encode.encode_core_scatter``;
- ``stream``: random buffer sizes through the host streaming codec;
- ``split``, ``window``, ``window-enc``, ``serving``: ``SplitDecoder`` at
  4-47 lanes, ``DeviceStreamDecoder`` windows of 600-60,000 bytes at 2-23
  split lanes, ``DeviceStreamEncoder`` windows of 256-8,192 pixels at one
  lane or eight, and ``ServingCodec`` under presets that make all three of
  its engines take toy sizes.

The first divergence raises ``Divergence``, naming the target, the seed and
the iteration; the same seed gives the same inputs again.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from .. import api, oracle
from ..common import END_MARKER, Channels, Desc, write_header
from ..convert import resolve_device
from . import add_device_args
from .bench import drive_stream_decode, drive_stream_encode


class Divergence(AssertionError):
    """A codec of the port disagreed with the oracle."""


def expect(cond, what: str) -> None:
    if not cond:
        raise Divergence(what)


def _same_result(got, want, what: str) -> None:
    """Two api Results: both errors with the same code, or both values
    with equal pixels."""
    expect(bool(got) == bool(want), f"{what}: {got} vs {want}")
    if want:
        expect(np.array_equal(got.value().data, want.value().data), what)
    else:
        expect(got.error() == want.error(), f"{what}: {got} vs {want}")


def fuzz_decode(rng, device, max_side=64):
    """Random chunk payload behind a valid header: oracle vs the one-shot
    device decoder."""
    from ..ops import backend

    w = int(rng.integers(1, max_side))
    h = int(rng.integers(1, max_side))
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    body_len = int(rng.integers(0, 5 * w * h + 30))
    body = rng.integers(0, 256, body_len, dtype=np.uint8)
    stream = np.frombuffer(
        write_header(desc) + body.tobytes() + END_MARKER, np.uint8)
    want = oracle.decode(stream, desc, ch)
    got = backend.decode_single(stream, desc, ch, device=device)
    expect(np.array_equal(got, want),
           f"decode divergence: {desc}, len={body_len}")


def fuzz_truncated(rng, device, max_side=48):
    """Truncated well-formed streams (tolerant decode), through the
    one-shot decoder and the api's torch backend."""
    from ..ops import backend

    w = int(rng.integers(2, max_side))
    h = int(rng.integers(2, max_side))
    ch = Channels.RGB if rng.random() < 0.5 else Channels.RGBA
    desc = Desc(w, h, ch)
    raw = (rng.integers(0, 5, w * h * int(ch)) * 11).astype(np.uint8)
    enc, _ = oracle.encode(raw, desc)
    cut = int(rng.integers(15, enc.size))
    stream = enc[:cut]
    want = oracle.decode(stream, desc, ch)
    got = backend.decode_single(stream, desc, ch, device=device)
    expect(np.array_equal(got, want),
           f"truncated divergence: {desc}, cut={cut}")
    _same_result(api.decode(stream, backend="torch", device=device),
                 api.decode(stream, backend="native"),
                 f"api truncated divergence: {desc}, cut={cut}")


def fuzz_encode_roundtrip(rng, device, max_side=64):
    """Random raw buffers: the api's torch backend and the scatter oracle
    must equal the oracle's encode."""
    from ..ops import encode as enc_ops
    from ..ops.bitops import pixels_to_packed

    w = int(rng.integers(1, max_side))
    h = int(rng.integers(1, max_side))
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    mode = rng.random()
    n = w * h * int(ch)
    if mode < 0.3:
        raw = rng.integers(0, 256, n, dtype=np.uint8)
    elif mode < 0.7:
        raw = (rng.integers(0, 4, n) * int(rng.integers(1, 80))).astype(
            np.uint8)
    else:
        raw = np.tile(rng.integers(0, 256, int(ch), dtype=np.uint8), w * h)
    want, complete = oracle.encode(raw, desc)
    expect(complete, f"the oracle stopped short: {desc}")
    got = api.encode(raw, desc, backend="torch", device=device).value()
    expect(np.array_equal(got, want), f"encode divergence: {desc}")

    n_px = w * h
    px = torch.zeros(enc_ops.pad_to_tile(n_px) * int(ch), dtype=torch.uint8)
    px[: raw.size] = torch.from_numpy(raw)
    header = torch.from_numpy(np.frombuffer(write_header(desc), np.uint8)
                              .copy()).to(device)
    out, total_len = enc_ops.encode_core_scatter(
        pixels_to_packed(px.to(device), int(ch)), n_px, header, int(ch))
    total_len = int(total_len)
    out = out.cpu().numpy()
    expect(np.array_equal(out[:total_len], want)
           and not out[total_len:].any(),
           f"encode_core_scatter divergence: {desc}")
    dec = oracle.decode(want, desc, ch)
    expect(np.array_equal(dec, raw), f"roundtrip failure: {desc}")


def fuzz_stream(rng, device, max_side=40):
    """Random buffer sizes through the host streaming codecs."""
    w = int(rng.integers(2, max_side))
    h = int(rng.integers(2, max_side))
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    raw = (rng.integers(0, 6, w * h * int(ch)) * 9).astype(np.uint8)
    want, _ = oracle.encode(raw, desc)

    enc_buf = int(rng.integers(5, 300))
    got = drive_stream_encode(raw, desc, enc_buf, feed=enc_buf)
    expect(np.array_equal(got, want),
           f"stream encode divergence: {desc}, buf={enc_buf}")

    dec_buf = int(rng.integers(max(int(ch), 5), 300))
    got_raw = drive_stream_decode(want, desc, dec_buf,
                                  feed=dec_buf)[: raw.size]
    expect(np.array_equal(got_raw, raw),
           f"stream decode divergence: {desc}, buf={dec_buf}")


def fuzz_split(rng, device, max_px=90_000):
    """SplitDecoder: one large stream spread across replay lanes, the
    seams reconciled by the fixpoint, must equal the oracle; INDEX-heavy
    palettes and long runs stress the state carried across lanes."""
    from ..models.split import SplitDecoder

    w = int(rng.integers(64, 400))
    h = max(min(int(rng.integers(64, 400)), max_px // w), 8)
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.3:  # palette (INDEX-heavy; entries survive across lanes)
        pal = rng.integers(0, 256, (int(rng.integers(3, 60)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    elif mode < 0.6:  # smooth gradients (DIFF/LUMA-heavy)
        raw = (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(np.uint8)
    elif mode < 0.8:  # long runs
        raw = np.repeat(rng.integers(0, 256, n // 97 + 1, dtype=np.uint8),
                        97)[:n].copy()
    else:  # noise (RGB/RGBA ops)
        raw = rng.integers(0, 256, n, dtype=np.uint8)
    if ch == Channels.RGBA and rng.random() < 0.5:
        raw.reshape(-1, 4)[:, 3] = 255
    enc, _ = oracle.encode(raw, desc)
    dec = SplitDecoder(lanes=int(rng.integers(4, 48)), device=device)
    outs = dec.decode([enc])
    expect(np.array_equal(outs[0], raw),
           f"split decode divergence: {desc}, lanes={dec.lanes}")


def fuzz_device_window(rng, device, max_px=60_000):
    """DeviceStreamDecoder: random window sizes tear chunks at any byte;
    the carried (prev, table) state and the torn tail fed again must stay
    exact, also where the split-lane compaction turns on or off between
    windows."""
    from ..ops.device_stream import DeviceStreamDecoder

    w = int(rng.integers(40, 300))
    h = max(min(int(rng.integers(40, 300)), max_px // w), 8)
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.35:  # runs (sparse chunk domain: compaction engages)
        rep = int(rng.integers(4, 40))
        raw = np.repeat(
            rng.integers(0, 256, (n // rep + 1,), dtype=np.uint8), rep
        )[:n].copy()
    elif mode < 0.65:  # palette (dense: compaction off)
        pal = rng.integers(0, 256, (int(rng.integers(3, 50)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    else:  # gradient
        raw = (np.cumsum(rng.integers(-2, 3, n)) % 256).astype(np.uint8)
    enc, _ = oracle.encode(raw, desc)
    win = int(rng.integers(600, 60_000))
    dec = DeviceStreamDecoder(
        window_cap=win + 1024, pixel_cap=-(-w * h // 8192) * 8192,
        split_lanes=int(rng.integers(2, 24)), device=device)
    expect(bool(dec.initialize(enc[:14])), f"header refused: {desc}")
    body = enc[14:-8]
    parts = []
    for s in range(0, body.size, win):
        r = dec.decode_window(body[s : s + win])
        expect(bool(r), f"decode_window failed: {desc}, win={win}: {r}")
        parts.append(r.value())
    got = np.concatenate([p for p in parts if p.size]
                         or [np.zeros(0, np.uint8)])
    expect(np.array_equal(got, raw),
           f"device window divergence: {desc}, win={win}, "
           f"lanes={dec.split_lanes}")


def fuzz_device_window_encode(rng, device, max_px=40_000):
    """DeviceStreamEncoder: random window capacities and feeds of whole
    pixels with the carried (prev, run, table) state must assemble the
    oracle's exact stream, finalize's pending run and end marker
    included."""
    from ..ops.device_stream import DeviceStreamEncoder

    w = int(rng.integers(30, 260))
    h = max(min(int(rng.integers(30, 260)), max_px // w), 6)
    ch = Channels.RGBA if rng.random() < 0.5 else Channels.RGB
    desc = Desc(w, h, ch)
    n = w * h * int(ch)
    mode = rng.random()
    if mode < 0.35:  # runs crossing window seams
        rep = int(rng.integers(3, 80))
        raw = np.repeat(
            rng.integers(0, 256, (n // rep + 1,), dtype=np.uint8), rep
        )[:n].copy()
    elif mode < 0.65:  # palette (INDEX state crosses windows)
        pal = rng.integers(0, 256, (int(rng.integers(3, 50)), int(ch)),
                           dtype=np.uint8)
        raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
    else:
        raw = (np.cumsum(rng.integers(-3, 4, n)) % 256).astype(np.uint8)
    want, _ = oracle.encode(raw, desc)
    # a fixed set of window sizes and lanes, as the JAX tool keeps its
    # compiled programs few; lanes > 1 runs the multi-lane window encoder
    wins = (256, 1024, 3000, 8192)
    lanes = (1, 8)[int(rng.integers(0, 2))]
    enc = DeviceStreamEncoder(window_px=int(wins[int(rng.integers(0, 4))]),
                              split_lanes=lanes, device=device)
    r = enc.initialize(desc)
    expect(bool(r), f"initialize failed: {desc}: {r}")
    stream = bytearray(r.value())
    step_px = int(rng.integers(1, enc.window_px + 1))
    step = step_px * int(ch)
    for s in range(0, n, step):
        r = enc.encode_window(raw[s : s + step])
        expect(bool(r), f"encode_window failed: {desc}: {r}")
        stream += bytes(r.value())
    r = enc.finalize()
    expect(bool(r), f"finalize failed: {desc}: {r}")
    stream += bytes(r.value())
    got = np.frombuffer(bytes(stream), np.uint8)
    expect(np.array_equal(got, want),
           f"device window encode divergence: {desc}, win={enc.window_px}, "
           f"step={step_px}")


# ServingCodec presets that make its packed tiers, split groups and
# geometry buckets all take toy sizes
SERVING_PRESETS = (
    dict(pack_lane_bytes=16 << 10, pack_lane_px=1 << 12,
         split_min_bytes=8 << 10, min_len=1 << 10),
    dict(pack_lane_bytes=8 << 10, pack_lane_px=1 << 11,
         split_min_bytes=4 << 10, min_len=1 << 10),
    # split_lanes=2 makes a group of split dispatches wherever more than
    # two streams go over the cap
    dict(pack_lane_bytes=16 << 10, pack_lane_px=1 << 12,
         split_min_bytes=2 << 10, min_len=1 << 10, split_lanes=2),
)


def fuzz_serving(rng, device, codecs=None):
    """ServingCodec: mixed corpora on both sides of every routing boundary
    (packed tier, split engine, bucketed batch) through decode and encode
    must equal the oracle stream by stream.  Geometries come from a small
    set so each preset's codec (kept in ``codecs`` across calls) reuses its
    pipelines."""
    from ..models.serving import ServingCodec

    codecs = {} if codecs is None else codecs
    key = int(rng.integers(0, len(SERVING_PRESETS)))
    codec = codecs.get(key)
    if codec is None:
        codec = codecs[key] = ServingCodec(**SERVING_PRESETS[key],
                                           device=device)

    geoms = [(40, 30), (64, 48), (100, 80), (128, 90)]
    b = int(rng.integers(2, 7))
    raws, blobs, descs = [], [], []
    for _ in range(b):
        w, h = geoms[int(rng.integers(0, len(geoms)))]
        ch = Channels.RGBA if rng.random() < 0.4 else Channels.RGB
        desc = Desc(w, h, ch)
        n = w * h * int(ch)
        mode = rng.random()
        if mode < 0.3:  # noise (dense streams: over split_min at 100x80+)
            raw = rng.integers(0, 256, n, dtype=np.uint8)
        elif mode < 0.6:  # palette
            pal = rng.integers(0, 256, (int(rng.integers(3, 40)), int(ch)),
                               dtype=np.uint8)
            raw = pal[rng.integers(0, len(pal), w * h)].reshape(-1)
        else:  # runs
            rep = int(rng.integers(5, 60))
            raw = np.repeat(
                rng.integers(0, 256, n // rep + 1, dtype=np.uint8), rep
            )[:n].copy()
        enc, complete = oracle.encode(raw, desc)
        expect(complete, f"the oracle stopped short: {desc}")
        raws.append(raw)
        blobs.append(enc)
        descs.append(desc)

    outs = codec.decode(blobs)
    for i, raw in enumerate(raws):
        expect(np.array_equal(outs[i], raw),
               f"serving decode divergence: stream {i} {descs[i]} "
               f"preset {key}")
    streams = codec.encode(raws, descs)
    for i, want in enumerate(blobs):
        expect(np.array_equal(streams[i], want),
               f"serving encode divergence: stream {i} {descs[i]} "
               f"preset {key}")


FUZZERS = {
    "decode": fuzz_decode,
    "truncated": fuzz_truncated,
    "encode": fuzz_encode_roundtrip,
    "stream": fuzz_stream,
    "split": fuzz_split,
    "window": fuzz_device_window,
    "window-enc": fuzz_device_window_encode,
    "serving": fuzz_serving,
}


def run(iterations: int, seed: int = 0, only=None, device=None,
        report=print) -> dict:
    """``iterations`` rounds of every target (or of ``only``) on ``device``
    (None means "cuda", which raises where there is no card), all drawing
    from one generator seeded ``seed``.  Raises Divergence at the first
    disagreement; returns each target's host-clock seconds."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    names = [only] if only else list(FUZZERS)
    targets = {n: FUZZERS[n] for n in names}
    if "serving" in targets:  # one codec a preset for the whole run
        targets["serving"] = functools.partial(fuzz_serving, codecs={})
    seconds = dict.fromkeys(targets, 0.0)
    for i in range(iterations):
        for name, fz in targets.items():
            t0 = time.perf_counter()
            try:
                fz(rng, dev)
            except Divergence as e:
                raise Divergence(f"{name} (seed {seed}, iteration {i}): "
                                 f"{e}") from e
            seconds[name] += time.perf_counter() - t0
        if (i + 1) % 10 == 0:
            report(f"{i + 1}/{iterations} iterations clean")
    return seconds


def main(argv=None):
    p = argparse.ArgumentParser(description="Differential QOI fuzzer")
    p.add_argument("-n", "--iterations", type=int, default=50)
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--only", choices=sorted(FUZZERS), default=None)
    add_device_args(p)
    args = p.parse_args(argv)
    seconds = run(args.iterations, args.seed, args.only, args.device,
                  report=functools.partial(print, flush=True))
    print("seconds a target: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    print(f"fuzz OK: {args.iterations} iterations x {len(seconds)} targets "
          f"on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
