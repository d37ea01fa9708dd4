"""Where the device time goes, per path: a torch.profiler trace of each
entry point at the smoke run's sizes, summed by kernel group.

    python -m qoipp_tpu_torch.utils.profile      # on a machine with a card
    python -m qoipp_tpu_torch.utils.profile --paths E6 E7 --calls 20

For each path (``--paths``: those whose label holds one of the texts) it
prints, per call (``--calls``, 3 by default, after 3 warmups; ten times
as many, marked, where the profiler kept no device event of those): the
device busy time (the union of kernel and copy intervals), the span from
the first to the last of them, the idle share of that span, and the busy
time by kernel group with launches.  The inputs are the smoke run's:
BatchPipeline on 16 RGB and 8 RGBA 1920x1088 images, SplitDecoder(96) on
the 4096x4096 sparse and the 1920x1088 dense stream, the one-shot codec
on one RGB and one RGBA 1920x1088 image, and the streaming codec on the
4096x4096 image (decode in 1 MB and 4 MB windows, encode in 2^18-pixel
windows at one lane and in 2^20-pixel windows at 16 lanes) and on the
RGBA image (encode in 2^18-pixel windows at 1 and 8 lanes), and the
windowed placement kernels on their experiments' main inputs (E2 at
each lanes, E5 at ns 2 and 4, E6 at each kernel its experiment runs --
full, no-fill, fill-3, no-slabs, no-dma, dma-only and bare -- and K2 on
the same 8 x 524,288 photo-like rows; E3 and K2 on the 128 x 284,928
bench-like rows), E4's exact variant (8192-pixel windows, G=1, dyn)
beside K2 on its script's 128 x 286,720 rows, and E7 at each lanes beside
K4 on its script's 8 x 2^17 rows and at 256 lanes on the same script's
rows at fill 0.999 (a trailing run of ~130 equal offs, not ~32,770), base
rows computed outside the call;
the profile_r2 probes at their own sizes, E8 at 4,096 and 65,536
steps and E9 at 2,048 blocks; and the serving path on the committed real
corpus x 8 (ServingCodec decode and encode, from the host and
pre-staged; PackedDecoder and PackedEncoder alone).
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

# (group, lower-case substring of the kernel name), first match wins
GROUPS = (
    ("K1/K5 replay", "replay_kernel"),
    ("E4 grouped placement", "place_grouped"),
    ("E7 emit_wide", "emit_window"),
    ("E8 grid probe", "grid_step"),
    ("E9 one-hot placement", "onehot_place"),
    ("K2 place_fill", "place_fill_kernel"),
    ("E2/E3/E5/E6 windowed placement", "place_"),
    ("K3 compact", "compact_kernel"),
    ("K4 emit", "emit_kernel"),
    ("K6 logfill", "logfill"),
    ("E1 fields", "fields_"),  # fields_kernel, fields_summary_kernel
    ("boundary scan", "chunk_starts"),
    ("G1 gather", "gather_pixels"),
    ("copies", "memcpy"),
    ("fills", "memset"),
    ("scans (cumsum, cummax)", "scan"),
    ("sort", "sort"),
    ("reductions", "reduce"),
    ("torch elementwise", "elementwise"),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, key in GROUPS if key in low), "other")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_path(fn, calls: int = 3, warmup: int = 3) -> dict:
    """Device busy ms, span ms and idle share per call of fn, busy ms and
    launches per call by kernel group, and the calls traced.  The
    profiler at times keeps no device event of a trace (in a long process
    more often): such a path is traced again, twice, over ten times the
    calls, and raises if it shows no device activity then either."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for calls in (calls, 10 * calls, 10 * calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("the profiler saw no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    groups: dict = {}
    for e in events:
        g = groups.setdefault(group_of(e.name), [0.0, 0])
        g[0] += e.time_range.end - e.time_range.start
        g[1] += 1
    busy = busy_us(spans)
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    return dict(busy_ms=busy / calls / 1e3, span_ms=span / calls / 1e3,
                idle=1 - busy / span, calls=calls,
                groups={k: (v[0] / calls / 1e3, v[1] / calls)
                        for k, v in sorted(groups.items(),
                                           key=lambda kv: -kv[1][0])})


def _paths(dev):
    """(label, fn) of every path the smoke run drives."""
    from .. import oracle
    from ..common import Channels, Desc
    from ..models.pipeline import BatchPipeline
    from ..models.split import SplitDecoder
    from ..ops import backend
    from ..ops.bitops import pixels_to_packed
    from .corpus import make_corpus, make_image

    paths = []
    firsts = []
    for label, b, seed, ch in (("rgb", 16, 0, 3), ("rgba", 8, 7, 4)):
        desc, raws, blobs = make_corpus(b, 1920, 1088, seed=seed,
                                        channels=ch)
        firsts.append((label, desc, raws[0], blobs[0]))
        ml = max(x.size for x in blobs)
        pipe = BatchPipeline(desc, max_stream_len=ml,
                             max_encode_len=ml + 4096, device=dev)
        streams, sizes = (torch.from_numpy(x).to(dev)
                          for x in pipe.pack_streams(blobs))
        packed = torch.nn.functional.pad(
            pixels_to_packed(torch.from_numpy(np.stack(raws)).to(dev), ch),
            (0, pipe.nb - pipe.n_px))
        paths.append((f"decode_packed {label} B={b}",
                      lambda p=pipe, s=streams, z=sizes: p.decode_packed(s, z)))
        paths.append((f"encode_packed_chunked {label} B={b}",
                      lambda p=pipe, x=packed: p.encode_packed_chunked(x, 8)))
    desc = Desc(4096, 4096, Channels.RGB)
    sparse = oracle.encode(make_image(4096, 4096, seed=3), desc)[0]
    for label, blob in (("sparse 4096x4096", sparse),
                        ("dense 1920x1088", firsts[0][3])):
        dec = SplitDecoder(lanes=96, device=dev)
        staged = dec.stage_plan(dec.plan_and_pack([blob]))
        paths.append((f"split {label} L=96 dispatch_staged",
                      lambda d=dec, s=staged: d.dispatch_staged(s)))
    for label, d, raw, blob in firsts:
        paths.append((f"decode_single {label}",
                      lambda d=d, b=blob: backend.decode_single(
                          b, d, d.channels, device=dev)))
    label, d, raw, _ = firsts[0]
    paths.append((f"encode_single {label}",
                  lambda d=d, r=raw: backend.encode_single(r, d, device=dev)))
    from ..ops.device_stream import stream_decode, stream_encode

    big = make_image(4096, 4096, seed=3)
    for cap in (1 << 20, 4 << 20):
        paths.append((f"stream decode 4096x4096 {cap >> 20} MB windows L=96",
                      lambda c=cap: stream_decode(sparse, c,
                                                  pixel_cap=4096 * 4096,
                                                  device=dev)))
    for window_px, lanes in ((1 << 18, 1), (1 << 20, 16)):
        paths.append((f"stream encode 4096x4096 {window_px} px L={lanes}",
                      lambda w=window_px, n=lanes: stream_encode(
                          big, desc, w, n, device=dev)))
    label, d, raw, _ = firsts[1]
    for lanes in (1, 8):
        paths.append((f"stream encode {label} {1 << 18} px L={lanes}",
                      lambda n=lanes, r=raw, d=d: stream_encode(
                          r, d, 1 << 18, n, device=dev)))
    return paths + _serving_paths(dev) + _window_paths(dev)


def _serving_paths(dev):
    """(label, fn) of the serving path on the committed real corpus x 8
    (128 requests), as chip_smoke drives it: ServingCodec's decode and
    encode, each from the host's streams or raw pixels (planning and
    uploads included) and pre-staged, and PackedDecoder and PackedEncoder
    alone (lanes of 8 MB and 2^21 pixels)."""
    from pathlib import Path

    from .. import oracle
    from ..common import read_header
    from ..models.packed import PackedDecoder, PackedEncoder
    from ..models.serving import ServingCodec

    corpus = (Path(__file__).resolve().parents[2] / "tests" / "resources"
              / "local_corpus")
    blobs = [np.fromfile(p, np.uint8)
             for p in sorted(corpus.glob("*.qoi"))] * 8
    descs = [read_header(b).value() for b in blobs]
    raws = [oracle.decode(b, d, d.channels) for b, d in zip(blobs, descs)]
    codec = ServingCodec(device=dev)
    dec = PackedDecoder(lane_bytes=8 << 20, device=dev)
    enc = PackedEncoder(lane_px=1 << 21, device=dev)
    n = len(blobs)
    staged = codec.decode_stage(blobs)
    estaged = codec.encode_stage(raws, descs)
    pstaged = enc.stage_to_device(raws, descs)
    return [
        (f"serving decode_dispatch {n} requests",
         lambda: codec.decode_dispatch(blobs)),
        (f"serving decode_dispatch_staged {n} requests",
         lambda: codec.decode_dispatch_staged(staged)),
        (f"serving encode_dispatch {n} requests",
         lambda: codec.encode_dispatch(raws, descs)),
        (f"serving encode_dispatch_staged {n} requests",
         lambda: codec.encode_dispatch_staged(estaged)),
        (f"packed PackedDecoder.decode_to_device {n} streams",
         lambda: dec.decode_to_device(blobs)),
        (f"packed PackedEncoder.dispatch_staged {n} streams",
         lambda: enc.dispatch_staged(pstaged)),
    ]


def _window_paths(dev):
    """(label, fn) of the windowed placement kernels and K2 on the
    experiments' main inputs."""
    from ..benchmarks import expt_place2, expt_place_fixed
    from ..ops import place_kernel
    from ..ops import place_window as PW

    def on_card(pb, em, n_cap):
        pb = torch.from_numpy(pb).to(dev)
        return pb, torch.from_numpy(em.view(np.int32)).to(dev), n_cap

    pb, em, n = on_card(*expt_place_fixed.gen_inputs(
        np.random.default_rng(0), 8, 1 << 19))
    base = PW.window_base_rows(pb, n)
    photo = "photo 8x524288"
    paths = [(f"K2 place_fill {photo}",
              lambda: place_kernel.place_fill(pb, em, n))]
    for lanes in PW.WIDE_LANES:
        paths.append((f"E2 place_wide lanes={lanes} {photo}",
                      lambda k=lanes, b=PW.window_base_rows_w(pb, n, lanes):
                      PW.place_wide(pb, em, b, n, lanes=k)))
    for ns in (2, 4):
        paths.append((f"E5 place_fill_narrow ns={ns} {photo}",
                      lambda k=ns: PW.place_fill_narrow(pb, em, base, n,
                                                        ns=k)))
    # E6's experiment variants less the ones that differ only in prec (one
    # kernel): each stage's device time comes by difference, the row reads
    # dma-only - bare, the fill no-slabs - dma-only, the placement full -
    # no-slabs
    for what, kw in (("full", {}), ("no-fill", dict(n_fill=0)),
                     ("fill-3", dict(n_fill=3)),
                     ("no-slabs", dict(do_slabs=False)),
                     ("no-dma", dict(do_dma=False, do_slabs=False)),
                     ("dma-only", dict(do_slabs=False, n_fill=0)),
                     ("bare", dict(do_dma=False, do_slabs=False, n_fill=0))):
        paths.append((f"E6 place_variant {what} {photo}",
                      lambda kw=kw: PW.place_variant(pb, em, base, n, **kw)))
    pb3, em3, n3 = on_card(*expt_place2.make_case(128, 284928, 0.40, 0.20))
    base3 = PW.window_base_rows(pb3, n3)
    bench = "bench-like 128x284928"
    return paths + [
        (f"K2 place_fill {bench}",
         lambda: place_kernel.place_fill(pb3, em3, n3)),
        (f"E3 place_fill2 {bench}",
         lambda: PW.place_fill2(pb3, em3, base3, n3))] + _e4_e7_paths(dev)


def _e4_e7_paths(dev):
    """(label, fn) of E4 beside K2 and E7 beside K4 on their scripts' main
    inputs, then E8 and E9 on their probe's."""
    from ..benchmarks import expt_emit_wide, expt_place, profile_r2
    from ..ops import emit_kernel, place_kernel, probes
    from ..ops import emit_window as EW
    from ..ops import place_window as PW

    pb_np, em_np, _ = expt_place.gen_inputs(np.random.default_rng(0))
    pb = torch.from_numpy(pb_np).to(dev)
    em = torch.from_numpy(em_np.view(np.int32)).to(dev)
    n = expt_place.N_CAP
    base = PW.step_base_rows(pb, n, PW.WIN)
    main = f"main {pb.shape[0]}x{pb.shape[1]}"
    off_np, tlo_np, thn_np, cap = expt_emit_wide.gen_inputs(
        np.random.default_rng(0), 8, 1 << 17)
    off = torch.from_numpy(off_np).to(dev)
    tlo, thn = (torch.from_numpy(x.view(np.int32)).to(dev)
                for x in (tlo_np, thn_np))
    full_np = expt_emit_wide.gen_inputs(np.random.default_rng(0), 8,
                                        1 << 17, fill=0.999)
    full = [torch.from_numpy(x.view(np.int32)).to(dev) for x in full_np[:3]]
    full_base = EW.window_base_rows_w(full[0], full_np[3], 256)
    rows = "8x131072 rows"
    return [
        (f"K2 place_fill {main}", lambda: place_kernel.place_fill(pb, em, n)),
        (f"E4 place_grouped dyn {main}",
         lambda: PW.place_grouped(pb, em, base, n)),
        (f"K4 emit_bytes {rows}",
         lambda: emit_kernel.emit_bytes(off, tlo, thn, cap))] + [
        (f"E7 emit_wide lanes={lanes} {rows}",
         lambda k=lanes, b=EW.window_base_rows_w(off, cap, lanes):
         EW.emit_wide(off, tlo, thn, b, cap, lanes=k))
        for lanes in EW.WIDE_LANES] + [
        (f"E7 emit_wide lanes=256 fill 0.999 {rows}",
         lambda: EW.emit_wide(*full, full_base, full_np[3]))] + [
        (f"E8 grid_step_probe {n} steps",
         lambda x=torch.zeros((n,) + probes.STEP_SHAPE, dtype=torch.int32,
                              device=dev): probes.grid_step_probe(x))
        for n in (4096, 65536)] + [
        (f"E9 onehot_place {profile_r2.NBLK} blocks",
         lambda tv=profile_r2.onehot_inputs(dev): probes.onehot_place(*tv))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="*", default=[""],
                    help="profile only the paths whose label holds one of "
                    "these")
    ap.add_argument("--calls", type=int, default=3,
                    help="traced calls a path (after 3 warmups)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    for label, fn in _paths(torch.device("cuda")):
        if not any(p in label for p in args.paths):
            continue
        r = profile_path(fn, calls=args.calls)
        parts = "; ".join(f"{g} {ms:.4f} ({n:g})"
                          for g, (ms, n) in r["groups"].items())
        traced = "" if r["calls"] == args.calls else f" ({r['calls']} calls)"
        print(f"{label}{traced}: busy {r['busy_ms']:.3f} ms, span "
              f"{r['span_ms']:.3f} ms, idle share {r['idle']:.3f} | "
              f"{parts}", flush=True)


if __name__ == "__main__":
    main()
