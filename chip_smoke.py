#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qoipp_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

0. prints the card (nvidia-smi name and power limit), torch and CUDA;
1. builds the fifteen CUDA kernels from qoipp_tpu_torch/csrc (thirteen
   sources, one nvcc each, started together) and the native oracle from
   native/qoi_ref.cpp;
2. checks each kernel against its plain PyTorch version on edge cases,
   bit-exact (tolerance 0; E9's float32 bins within 1e-6);
3. drives four paths, each against the oracle, bit-exact:
   - BatchPipeline at 1920x1088, 16 RGB and 8 RGBA synthetic images
     (utils.corpus.make_corpus): decode_packed must equal the oracle's
     pixels, encode_packed_chunked and encode the oracle's streams;
   - SplitDecoder(lanes=96) on one 4096x4096 RGB stream (make_image, the
     sparse case, chunk-domain compaction) and one 1920x1088 RGB stream
     (the dense case, byte domain): decode_to_device must equal the
     oracle's pixels;
   - the one-shot codec (ops/backend): decode_single of a 1920x1088 RGB
     and an RGBA stream, encode_single of the RGB image;
   - the streaming codec (ops/device_stream), as
     benchmarks/device_stream_bench.py drives the JAX package's: the
     4096x4096 RGB stream decoded by DeviceStreamDecoder(96 lanes) fed in
     window_cap pieces at window_cap 1 MB (2 windows) and 4 MB (1 window),
     and the raw image encoded by DeviceStreamEncoder at 2^18-pixel
     windows on one lane and 2^20-pixel windows on 16; the first RGBA
     1920x1088 image decoded at 1 MB and encoded at 2^18 pixels on 1 and
     8 lanes.  Decoded pixels must equal the oracle's, encoded streams
     (header, windows, finalize) its bytes;
   - the windowed placement experiments E2, E3, E5 and E6
     (qoipp_tpu_torch/benchmarks: expt_place_wide, expt_place2,
     expt_place_narrow, expt_place_fixed), each main at its own sizes:
     every variant against the plain windowed placement and, where exact,
     against K2, on the whole output, bit-exact, then timed beside K2;
   - E4's experiment (benchmarks/expt_place, B=128 x 286,720 rows, n_cap
     2,088,960): its exact variant against the plain grouped summed
     placement on the whole output and K2 up to each image's last chunk
     start, both variants timed beside K2; E7's (benchmarks/
     expt_emit_wide, 8 x 2^17 rows, four variants) against K4's plain
     version and K4 on the whole output, timed beside K4; and the probes
     of benchmarks/profile_r2 on the batch RGB corpus (the stage profile,
     torch's scatter and cumsum rates, E8 at 4,096 / 16,384 / 65,536
     steps, E9 at 2,048 blocks of 2,048 targets), E8 and E9 against their
     plain versions;
4. requires each kernel of each path to have launched in that path's run
   (counts set to 0 just before each run and read just after);
5. checks each kernel against its plain version again at its path's
   shapes and times both (E2-E6 beside K2, E7 beside K4 on the same
   inputs, E3-E6 also in device time beside K2's, with their launch
   configuration and ptxas report, E3 with the share of its windows that
   take the long search, E6 with the global loads in the SASS of each
   instantiation, so that those which read rows they do not place show
   that they still read them; E8 and E9 from the probes' run, beside their
   torch calls; K2 on
   the batch and the split path's whole output and E1 at both
   stream-encode shapes and, logged only, at 8 batch RGB images, each
   also in device time (torch.profiler) and beside its first build's
   time; K3 as the whole compact_rows call (device time by kernel group,
   beside its first build's time) and K6 also in device time, both with
   their launch configuration and ptxas report; K1 and K5 on the first
   and on the last 4,096 rows, the last from the kernel's own carry,
   timed beside the first build's time and their chain bound: the
   longest chain of dependent operations the function needs on those
   rows, at the dependent-issue latency and SM clock the card shows in
   the same run), runs the replay class probe
   (benchmarks/replay_probe: K1 at 16 x 277,888 rows and K5 at 96 x
   12,288 on all-NOP, all-SETA, all-ADD and all-IDX rows and the cells'
   own, in ns a row), then times every path (1 cold, 3 warmup, 5 timed
   runs, CUDA events).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure raises, so the script exits
non-zero with no final line; so does a machine without a CUDA device.
It imports neither JAX nor the JAX package.
"""

import sys

for _name in ("jax", "qoipp_tpu", "bench", "benchmarks"):
    sys.modules[_name] = None  # the port runs where these are absent

import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qoipp_tpu_torch import kernels, oracle  # noqa: E402
from qoipp_tpu_torch.benchmarks import (  # noqa: E402
    expt_emit_wide,
    expt_place,
    expt_place2,
    expt_place_fixed,
    expt_place_narrow,
    expt_place_wide,
    profile_r2,
    replay_probe,
    timed_ms,
)
from qoipp_tpu_torch.common import Channels, Desc  # noqa: E402
from qoipp_tpu_torch.kernels import selfcheck  # noqa: E402
from qoipp_tpu_torch.models import split  # noqa: E402
from qoipp_tpu_torch.models.pipeline import BatchPipeline  # noqa: E402
from qoipp_tpu_torch.ops import (  # noqa: E402
    backend,
    compact_kernel,
    decode as dec_ops,
    device_stream,
    emit_kernel,
    emit_window,
    encode as enc_ops,
    fields_kernel,
    place_kernel,
    place_window,
    probes,
    replay_kernel,
)
from qoipp_tpu_torch.ops.bitops import pixels_to_packed  # noqa: E402
from qoipp_tpu_torch.utils import profile  # noqa: E402
from qoipp_tpu_torch.utils.corpus import make_corpus, make_image  # noqa: E402

W, H = 1920, 1088
CORPORA = (("rgb", 16, 0, 3), ("rgba", 8, 7, 4))  # label, B, seed, channels
SPLIT_SIDE = 4096  # the sparse split stream is SPLIT_SIDE x SPLIT_SIDE RGB
SPLIT_LANES = 96  # SplitDecoder's serving default
PLAIN_REPLAY_ROWS = 4096  # the plain replay loop runs 0.2-0.4 ms per row
# the kernels as first built, ms a call at the shapes phase 5 times, on an
# H100 80GB HBM3 at 700 W (PERF.md §6): K1 and K5 one thread a lane, 32
# lanes a block; K2 a binary search a pixel; E1 one block a row; K3 (the
# whole compact_rows call) a torch.cumsum and a scatter a row
FIRST_BUILD_MS = {"replay": 51.143, "replay_summary": 2.113,
                  "place_fill batch": 1.158, "place_fill split": 0.722,
                  "fields 1 x 262144": 0.4419, "fields 16 x 65536": 0.1135,
                  "compact": 3.469}
# dependent instructions from one state row's value to the next in the
# replay chain thread's loop as built (python -m
# qoipp_tpu_torch.benchmarks.replay_probe --sass FILE; PERF.md): this
# design's floor, not the function's
DESIGN_CHAIN_INSTRS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
OPS_PER_S = 67e12  # H100 SXM, published 32-bit rate outside the tensor cores
KERNELS = {  # name -> (source, the TPU kernel's function it replaces)
    "replay": ("qoipp_tpu_torch/csrc/replay.cu",
               "qoipp_tpu/ops/replay_kernel.py:183"),
    "place_fill": ("qoipp_tpu_torch/csrc/place_fill.cu",
                   "qoipp_tpu/ops/place_kernel.py:212"),
    "compact": ("qoipp_tpu_torch/csrc/compact.cu",
                "qoipp_tpu/ops/compact_kernel.py:212"),
    "emit": ("qoipp_tpu_torch/csrc/emit.cu",
             "qoipp_tpu/ops/emit_kernel.py:225"),
    "replay_summary": ("qoipp_tpu_torch/csrc/replay.cu",
                       "qoipp_tpu/ops/replay_kernel.py:225"),
    "logfill": ("qoipp_tpu_torch/csrc/logfill.cu",
                "qoipp_tpu/ops/replay_kernel.py:302"),
    "fields": ("qoipp_tpu_torch/csrc/fields.cu",
               "benchmarks/fields_kernel.py:253"),
    "place_wide": ("qoipp_tpu_torch/csrc/place_window.cu",
                   "benchmarks/expt_place_wide.py:206"),
    "place_fill2": ("qoipp_tpu_torch/csrc/place_fill2.cu",
                    "benchmarks/expt_place2.py:181"),
    "place_fill_narrow": ("qoipp_tpu_torch/csrc/place_narrow.cu",
                          "benchmarks/expt_place_narrow.py:192"),
    "place_variant": ("qoipp_tpu_torch/csrc/place_variant.cu",
                      "benchmarks/expt_place_fixed.py:174"),
    "place_grouped": ("qoipp_tpu_torch/csrc/place_grouped.cu",
                      "benchmarks/expt_place.py:163"),
    "emit_window": ("qoipp_tpu_torch/csrc/emit_window.cu",
                    "benchmarks/expt_emit_wide.py:223"),
    "grid_step": ("qoipp_tpu_torch/csrc/probes.cu",
                  "benchmarks/profile_r2.py:161"),
    "onehot_place": ("qoipp_tpu_torch/csrc/probes.cu",
                     "benchmarks/profile_r2.py:191"),
}
# 32-bit operations per element of each kernel's work (per row and lane for
# the replays: class decode, selects, per-byte add, hash, table write; per
# input row for compact; per output byte for emit; per pixel for fields:
# compare, streak, hash, table lookup, four deltas, op selection, template
# packing); logfill counts its own from the data
OPS_PER_ELEMENT = {"replay": 24, "replay_summary": 28, "compact": 3,
                   "emit": 4, "fields": 60}
# the windowed placement (K2, E2-E6): per candidate row the writer and
# window tests, per pixel six fill passes of a test and a select and the
# carry select
WINDOW_OPS_PER_ROW, WINDOW_OPS_PER_PIXEL = 4, 14
# E2, E3, E5, E6: kernel -> (experiment module, a function making the main
# input its phase 5 row times, (case, pb, emits, n_cap) as numpy, the
# rows per base_step unit, and the wrapper's call with its defaults)
EXPERIMENTS = {
    "place_wide": (
        expt_place_wide,
        lambda: ("photo b=8", *expt_place_wide.gen_inputs(
            np.random.default_rng(0), 8, 1 << 19)),
        256, place_window.place_wide),
    "place_fill2": (
        expt_place2,
        lambda: ("bench-like B=128", *expt_place2.make_case(
            128, 284928, 0.40, 0.20)),
        place_window.SLAB, place_window.place_fill2),
    "place_fill_narrow": (
        expt_place_narrow,
        lambda: ("photo b=8", *expt_place_narrow.gen_case(
            np.random.default_rng(0), 8, 1 << 19, 0.002)),
        place_window.SLAB, place_window.place_fill_narrow),
    "place_variant": (
        expt_place_fixed,
        lambda: ("photo b=8", *expt_place_fixed.gen_inputs(
            np.random.default_rng(0), 8, 1 << 19)),
        place_window.SLAB, place_window.place_variant),
}
STREAM_DECODE = ((1 << 20, "sparse"), (4 << 20, "sparse"),
                 (1 << 20, "rgba"))  # window_cap, image
STREAM_ENCODE = ((1 << 18, 1, "sparse"), (1 << 20, 16, "sparse"),
                 (1 << 18, 1, "rgba"), (1 << 18, 8, "rgba"))  # px, lanes
FIELDS_SHAPES = ((1, 1 << 18), (16, 1 << 16))  # the two encode windows
FIELDS_BATCH = 8  # E1's logged third shape: 8 batch RGB images
PROBE_RUNS = 5  # timed calls per profile_r2 probe


PTXAS = {}  # kernel entry (mangled name) -> ptxas' "Used ..." report


def ptxas_of(name):
    """ptxas' report of the kernels whose entry name holds ``name``."""
    return "; ".join(v for k, v in PTXAS.items() if name in k) or \
        "not reported"


def log(*a):
    print(*a, flush=True)


def expect(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, ops):
    """The least time the card could take: (s, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def device_ms(fn, group):
    """Device time a call of fn spends in kernel group ``group`` under
    torch.profiler over 20 calls: the mean interval of the group's kernels
    the profiler kept, times the launches a call.  The profiler may drop
    events (its window's first; in one run a quarter of a kernel's), so
    the launches a call are what it saw, rounded up."""
    groups = profile.profile_path(fn, calls=20, warmup=1)["groups"]
    expect(group in groups, f"the profiler saw no {group} kernel")
    ms, launches = groups[group]
    return ms / launches * math.ceil(launches - 1e-9)


def phase0_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return card.splitlines()[0]


def phase1_build():
    t0 = time.perf_counter()
    report = kernels.build(verbose=True)
    kernels.library()
    log(f"phase 1: built {kernels.LIB_PATH.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    entry = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry:
            PTXAS[entry] = line.split(":", 1)[1].strip()
            log(f"  ptxas: {entry}: {PTXAS[entry]}")
        elif "spill" in line:
            log("  ptxas:", line.strip())
    t0 = time.perf_counter()
    oracle.build()
    log(f"phase 1: built {oracle.LIB_PATH.name} in "
        f"{time.perf_counter() - t0:.1f} s")


def phase2_edge_cases(dev):
    for name in KERNELS:
        err = selfcheck.check(name, dev)
        log(f"phase 2: {name} vs plain on edge cases: max_abs_err {err}")
        expect(err <= selfcheck.TOLERANCE.get(name, 0),
               f"{name} disagrees with its plain version")


def _oracle_packed(desc, blobs, dev):
    px = np.stack([oracle.decode(b, desc, desc.channels) for b in blobs])
    return pixels_to_packed(torch.from_numpy(px).to(dev), int(desc.channels))


def _expected_streams(blobs, out_cap, dev):
    want = np.zeros((len(blobs), out_cap), np.uint8)
    for i, b in enumerate(blobs):
        want[i, : b.size] = b
    return (torch.from_numpy(want).to(dev),
            torch.tensor([b.size for b in blobs], dtype=torch.int32,
                         device=dev))


def phase3_prepare(dev):
    runs = []
    for label, b, seed, ch in CORPORA:
        t0 = time.perf_counter()
        desc, raws, blobs = make_corpus(b, W, H, seed=seed, channels=ch)
        max_len = max(x.size for x in blobs)
        pipe = BatchPipeline(desc, max_stream_len=max_len,
                             max_encode_len=max_len + 4096, device=dev)
        streams, sizes = pipe.pack_streams(blobs)
        raws = np.stack(raws)
        packed_in = torch.nn.functional.pad(
            pixels_to_packed(torch.from_numpy(raws).to(dev), ch),
            (0, pipe.nb - pipe.n_px))
        runs.append(dict(
            label=label, desc=desc, pipe=pipe, blobs=blobs, raws=raws,
            streams=torch.from_numpy(streams).to(dev),
            sizes=torch.from_numpy(sizes).to(dev), packed_in=packed_in,
            want_px=_oracle_packed(desc, blobs, dev),
            want=_expected_streams(blobs, pipe.out_cap, dev)))
        log(f"phase 3: corpus {label}: {b} x {W}x{H}, streams "
            f"{min(x.size for x in blobs)}..{max_len} bytes, qb={pipe.qb}, "
            f"chunk_cap={pipe.chunk_cap}, out_cap={pipe.out_cap} "
            f"(made in {time.perf_counter() - t0:.1f} s)")
    return runs


def phase3_prepare_split(runs, dev):
    """The split path's two streams: the sparse SPLIT_SIDE^2 image and the
    dense first image of the RGB corpus."""
    t0 = time.perf_counter()
    desc = Desc(SPLIT_SIDE, SPLIT_SIDE, Channels.RGB)
    raw = make_image(SPLIT_SIDE, SPLIT_SIDE, seed=3)
    blob, complete = oracle.encode(raw, desc)
    expect(complete, "the oracle did not finish the sparse stream")
    rgb = runs[0]
    streams = (("sparse", desc, raw, blob),
               ("dense", rgb["desc"], rgb["raws"][0], rgb["blobs"][0]))
    out = []
    for label, d, r, b in streams:
        dec = split.SplitDecoder(lanes=SPLIT_LANES, device=dev)
        plan = dec.plan_and_pack([b])
        out.append(dict(label=label, desc=d, raw=r, blob=b, dec=dec,
                        plan=plan, want=oracle.decode(b, d, d.channels)))
        log(f"phase 3: split {label}: {d.width}x{d.height}, {b.size} bytes, "
            f"lanes {plan[0].shape[0]}, qb {plan[6]}, qc {plan[9]}, "
            f"n_cap {plan[7]}, max_chain {plan[8]}")
    log(f"phase 3: split streams made in {time.perf_counter() - t0:.1f} s")
    return out


def phase3_prepare_oneshot(runs, dev):
    """The one-shot path's images: the first of each corpus."""
    out = []
    for run in runs:
        d = run["desc"]
        out.append(dict(label=run["label"], desc=d, dev=dev,
                        raw=run["raws"][0],
                        blob=run["blobs"][0],
                        want=oracle.decode(run["blobs"][0], d, d.channels)))
    return out


def phase3_prepare_stream(runs, split_runs):
    """The streaming path's sessions (STREAM_DECODE, STREAM_ENCODE) over
    the sparse split image and the first image of the RGBA corpus."""
    rgba = runs[1]
    images = {"sparse": split_runs[0],
              "rgba": dict(desc=rgba["desc"], raw=rgba["raws"][0],
                           blob=rgba["blobs"][0],
                           want=oracle.decode(rgba["blobs"][0], rgba["desc"],
                                              rgba["desc"].channels))}
    sessions = []
    for cap, name in STREAM_DECODE:
        im = images[name]
        d = im["desc"]
        # the pixel cap of device_stream_bench.py: the image, in 8192s
        sessions.append(dict(
            kind="decode", im=im, cap=cap,
            pixel_cap=-(-d.width * d.height // 8192) * 8192,
            label=f"stream decode {name} {d.width}x{d.height} window_cap "
                  f"{cap >> 20} MB L=96"))  # the decoder's default lanes
    for px, lanes, name in STREAM_ENCODE:
        im = images[name]
        d = im["desc"]
        sessions.append(dict(
            kind="encode", im=im, px=px, lanes=lanes,
            label=f"stream encode {name} {d.width}x{d.height} window 2^"
                  f"{px.bit_length() - 1} px L={lanes}"))
    return sessions


def _stream_session(s, dev):
    im = s["im"]
    if s["kind"] == "decode":
        return device_stream.stream_decode(
            im["blob"], s["cap"], pixel_cap=s["pixel_cap"], device=dev)
    return device_stream.stream_encode(im["raw"], im["desc"], s["px"],
                                       s["lanes"], device=dev)


def phase3_stream(s, dev):
    got = _stream_session(s, dev)
    if s["kind"] == "encode":
        expect(got == s["im"]["blob"].tobytes(),
               f"{s['label']}: stream differs from the oracle's")
        log(f"phase 3: {s['label']}: {len(got)} bytes, equal to the oracle")
        return
    pixels, dec = got
    expect(np.array_equal(pixels, s["im"]["want"]),
           f"{s['label']}: pixels differ from the oracle's")
    s["windows"] = dec.windows
    for i, w in enumerate(dec.windows):
        log(f"phase 3: {s['label']} window {i}: lanes {w['lanes']}, qb "
            f"{w['qb']}, qc {w['qc']}, n_cap {w['n_cap']}, rounds "
            f"{w['rounds']}, max_chain {w['max_chain']}")
    log(f"phase 3: {s['label']}: equal to the oracle")


def _stream_needs(s):
    """The kernels a streaming session must launch: decode K5 and K2 (and
    K3 where a window took the chunk domain), encode E1, K3 and K4."""
    if s["kind"] == "encode":
        return ("fields", "compact", "emit")
    return ("replay_summary", "place_fill") + (
        ("compact",) if any(w["qc"] for w in s["windows"]) else ())


def _check_streams(run, out, lengths, ok, what):
    want, want_len = run["want"]
    col = torch.arange(out.shape[1], device=out.device)[None, :]
    same = torch.where(col < want_len[:, None], out == want, True).all(dim=1)
    good = same & (lengths == want_len) & ok
    expect(bool(good.all()), f"{what}[{run['label']}]: images "
           f"{torch.nonzero(~good).flatten().tolist()} differ from the oracle")


def phase3_main_path(runs):
    for run in runs:
        pipe = run["pipe"]
        packed = pipe.decode_packed(run["streams"], run["sizes"])
        same = (packed[:, : pipe.n_px] == run["want_px"]).all(dim=1)
        expect(bool(same.all()), f"decode[{run['label']}]: images "
               f"{torch.nonzero(~same).flatten().tolist()} differ")
        _check_streams(run, *pipe.encode_packed_chunked(run["packed_in"],
                                                        sub=8),
                       "encode_packed_chunked")
        out, lengths = pipe.encode(run["raws"])
        _check_streams(run, out, lengths, torch.ones_like(lengths, dtype=bool),
                       "encode")
        log(f"phase 3: {run['label']}: decode_packed, encode_packed_chunked "
            f"and encode equal the oracle on all {len(run['blobs'])} images")


def phase3_split(run):
    dec = run["dec"]
    packed, where, descs, rounds = dec.decode_to_device([run["blob"]])
    got = dec.gather(packed, where, descs)[0]
    expect(np.array_equal(got, run["want"]),
           f"split[{run['label']}]: pixels differ from the oracle")
    run["rounds"] = rounds
    plan = run["plan"]
    log(f"phase 3: split {run['label']}: lanes {plan[0].shape[0]}, qb "
        f"{plan[6]}, qc {plan[9]}, rounds {rounds}, max_chain {plan[8]}: "
        "equal to the oracle")


def phase3_oneshot_decode(run):
    d = run["desc"]
    got = backend.decode_single(run["blob"], d, d.channels,
                                device=run["dev"])
    expect(np.array_equal(got, run["want"]),
           f"decode_single[{run['label']}]: pixels differ from the oracle")
    log(f"phase 3: decode_single[{run['label']}] equals the oracle")


def phase3_oneshot_encode(run):
    got = backend.encode_single(run["raw"], run["desc"], device=run["dev"])
    expect(np.array_equal(got, run["blob"]),
           f"encode_single[{run['label']}]: stream differs from the oracle")
    log(f"phase 3: encode_single[{run['label']}] equals the oracle")


def phase3_experiment(name, results, dev):
    """One experiment's main at its own sizes: every variant held against
    the plain windowed placement (and K2) and timed beside K2."""
    module = EXPERIMENTS[name][0]
    log(f"phase 3: {module.__name__}.main()")
    results[name] = module.main([], device=dev)


def phase3_expt_place(results, dev):
    """E4's main at its own sizes: the exact variant against the plain
    grouped summed placement and K2, both variants timed beside K2."""
    log("phase 3: qoipp_tpu_torch.benchmarks.expt_place.main()")
    results["place_grouped"] = expt_place.main([], device=dev)


def phase3_expt_emit_wide(results, dev):
    """E7's main at its own sizes: every variant against K4's plain version
    and K4, timed beside K4."""
    log("phase 3: qoipp_tpu_torch.benchmarks.expt_emit_wide.main()")
    results["emit_window"] = expt_emit_wide.main([], device=dev)


def phase3_probes(run, results, dev):
    """profile_r2's probes, the stage profile on the batch RGB corpus (the
    smoke run's batch, not the script's 128), E8 and E9 at their own
    sizes."""
    log(f"phase 3: qoipp_tpu_torch.benchmarks.profile_r2.run_probes() on "
        f"the {run['label']} corpus")
    results["probes"] = profile_r2.run_probes(
        run["pipe"], run["streams"], run["sizes"], run["streams"].device,
        runs=PROBE_RUNS)


def drive(label, fn, needs, totals):
    """Run one path with every launch count at 0, then require each kernel
    of `needs` (or of what `needs()` returns after the run) to have
    launched in it; add the counts to totals."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"phase 4: launches on {label}: "
        f"{ {k: v for k, v in launches.items() if v} }")
    for name in (needs() if callable(needs) else needs):
        expect(launches[name] > 0, f"{label} never launched {name}")
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n


def _kernel_row(name, launches, err, ms, plain_ms, nbytes, ops,
                library_ms=None, **extra):
    source, replaces = KERNELS[name]
    bound_s, bound_by = bound(nbytes, ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by,
                library_ms=library_ms, **extra)


def _replay_bytes(c, b, summary):
    """meta and val read, emits written; the 65-word state read and
    written per lane (and K5's 65 summary words written)."""
    return 12 * c * b + 4 * b * (65 * 2 + (65 if summary else 0))


def _replay_row(name, meta_t, val_t, carry, launches, card, what):
    """K1 ("replay") or K5 ("replay_summary") on the rows its path gives it,
    from ``carry``: held against its plain version on the first
    PLAIN_REPLAY_ROWS rows, and on the last PLAIN_REPLAY_ROWS from the
    kernel's own carry after the rows before them (the emits there, the
    final prev and table), then timed beside the plain version and the
    first build's time.  The chain bound beside the row's bound: the
    longest chain of dependent operations the function needs on these rows
    (replay_probe.chain_depth) at the dependent-issue latency and the SM
    clock measured just after the timed calls (replay_probe.chain_latency);
    the share is the kernel's time against the larger of the two."""
    fn, ref = ((replay_kernel.replay_batch_carry,
                replay_kernel.replay_batch_carry_reference)
               if name == "replay" else
               (replay_kernel.replay_batch_summary,
                replay_kernel.replay_batch_summary_reference))
    c, b = meta_t.shape
    n = min(PLAIN_REPLAY_ROWS, c)
    pm, pv = meta_t[:n], val_t[:n]
    err = max(selfcheck.max_abs_err(g, w) for g, w in
              zip(fn(pm, pv, *carry), ref(pm, pv, *carry)))
    expect(err == 0, f"{name} disagrees with its plain version on the "
           f"first {n} rows")
    full = fn(meta_t, val_t, *carry)
    cut = c - n
    mid = fn(meta_t[:cut], val_t[:cut], *carry)[1:3] if cut else carry
    want = ref(meta_t[cut:], val_t[cut:], *mid)
    tail_err = max(selfcheck.max_abs_err(full[0][cut:], want[0]),
                   selfcheck.max_abs_err(full[1], want[1]),
                   selfcheck.max_abs_err(full[2], want[2]))
    expect(tail_err == 0, f"{name} disagrees with its plain version on the "
           f"last {n} rows")
    depth = replay_probe.chain_depth(meta_t, full[0])
    del full, want
    ms = timed_ms(lambda: fn(meta_t, val_t, *carry))
    lat, mhz = replay_probe.chain_latency(meta_t.device)
    prefix_ms = timed_ms(lambda: fn(pm, pv, *carry))
    plain_ms = timed_ms(lambda: ref(pm, pv, *carry), warmup=1, runs=1)
    n_state = replay_probe.state_rows(meta_t)
    chain_ms = depth * lat / (mhz * 1e3)
    floor_ms = n_state * DESIGN_CHAIN_INSTRS * lat / (mhz * 1e3)
    nbytes = _replay_bytes(c, b, name == "replay_summary")
    ops = OPS_PER_ELEMENT[name] * c * b
    row = _kernel_row(
        name, launches[name], max(err, tail_err), ms, plain_ms, nbytes, ops,
        rows=c, lanes=b, plain_rows=n, ms_on_plain_rows=prefix_ms,
        ns_per_row=ms / c * 1e6, state_rows=n_state,
        ns_per_state_row=ms / n_state * 1e6)
    share = max(row["bound_ms"], chain_ms) / ms
    log(f"phase 5: {name} ({what}, C={c}, B={b}): {ms:.3f} ms, "
        f"{ms / c * 1e6:.2f} ns/row, {ms / n_state * 1e6:.2f} ns per state "
        f"row ({n_state} on the longest lane); first build (one thread a "
        f"lane) {FIRST_BUILD_MS[name]} ms; chain bound {chain_ms:.5f} ms "
        f"({depth} dependent operations on the longest chain; {lat:.3f} "
        f"cycles each at {mhz:.0f} MHz, measured after the timed calls), "
        f"bytes bound {row['bound_ms']:.5f} ms, share {share:.3f}; this "
        f"design's chain floor {floor_ms:.4f} ms ({DESIGN_CHAIN_INSTRS} "
        f"dependent "
        f"instructions a state row); plain on {n} rows {plain_ms:.1f} ms "
        f"(kernel on those rows {prefix_ms:.3f} ms); head and tail windows "
        f"equal the plain version, on {card}")
    return row


def phase5_kernels_at_main_shapes(run, launches, card):
    """Each kernel of the batch path against its plain version on the
    inputs that path gives it (RGB corpus), and both timed."""
    pipe = run["pipe"]
    meta_t, val_t, pix_before = pipe.replay_inputs(run["streams"],
                                                   run["sizes"])
    rows = [_replay_row(
        "replay", meta_t, val_t,
        replay_kernel.initial_state(meta_t.shape[1], meta_t.device),
        launches, card, "batch RGB")]

    emits = replay_kernel.replay_batch(meta_t, val_t).T.contiguous()
    k2 = _place_fill_time(pix_before, emits, pipe.n_cap, "batch", card)
    rows.append(_kernel_row("place_fill", launches["place_fill"], k2["err"],
                            k2["ms"], k2["plain_ms"], k2["bytes"],
                            k2["ops"], device_ms=k2["device_ms"],
                            rows=k2["rows"], images=k2["images"],
                            n_cap=k2["n_cap"]))

    packed = run["packed_in"][:8]  # the sub-batch encode_packed_chunked runs
    posflag, keep, fb = enc_ops.chunk_positions(packed, pipe.n_px)
    k3, (pk_c, pf_c), counts = _compact_time(packed, posflag, keep,
                                             pipe.chunk_cap, card)
    rows.append(_kernel_row(
        "compact", launches["compact"], k3.pop("err"), k3.pop("ms"),
        k3.pop("plain_ms"), k3.pop("bytes"), k3.pop("ops"), **k3))

    off, tlo, thn, _ = enc_ops.chunk_templates(pk_c, pf_c, counts, pipe.n_px,
                                               fb, pipe.channels)
    args = (off, tlo, thn, pipe.out_cap)
    err = selfcheck.max_abs_err(emit_kernel.emit_bytes(*args),
                                emit_kernel.emit_bytes_reference(*args))
    expect(err == 0, "emit disagrees with its plain version")
    ms = timed_ms(lambda: emit_kernel.emit_bytes(*args))
    plain_ms = timed_ms(lambda: emit_kernel.emit_bytes_reference(*args))
    log(f"phase 5: emit (8 x {off.shape[1]} rows -> {pipe.out_cap} bytes): "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows.append(_kernel_row(
        "emit", launches["emit"], err, ms, plain_ms,
        12 * off.numel() + off.shape[0] * pipe.out_cap,
        OPS_PER_ELEMENT["emit"] * off.shape[0] * pipe.out_cap))
    return rows


def _compact_time(packed, posflag, keep, cap, card):
    """K3 on batch encode's sub-batch rows against its plain version on
    counts and the rows below counts, the whole compact_rows call timed
    (events, and device time by kernel group) beside the plain version
    and the first build; its launch configuration logged.  The bound
    counts what the function must move: keep once, each kept row's plane
    values read and written once, counts; the first build's formula (every
    plane row read, cap rows written) is logged beside it."""
    args = ((packed, posflag), keep, cap)
    (pk_c, pf_c), counts = compact_kernel.compact_rows(*args)
    (rk_c, rf_c), rcounts = compact_kernel.compact_rows_reference(*args)
    live = torch.arange(cap, device=counts.device)[None, :] < \
        counts[:, None]
    err = max(selfcheck.max_abs_err(counts, rcounts),
              *(selfcheck.max_abs_err(torch.where(live, g, 0),
                                      torch.where(live, w, 0))
                for g, w in ((pk_c, rk_c), (pf_c, rf_c))))
    expect(err == 0, "compact disagrees with its plain version")
    call = lambda: compact_kernel.compact_rows(*args)
    ms = timed_ms(call)
    prof = profile.profile_path(call, calls=20, warmup=1)
    expect("K3 compact" in prof["groups"], "the profiler saw no K3 kernel")
    dev_ms = prof["groups"]["K3 compact"][0]
    # the same launch with no row kept: keep read, scans and look-back only
    none_kept = torch.zeros_like(keep)
    empty_ms = device_ms(
        lambda: compact_kernel.compact_rows((packed, posflag), none_kept, cap),
        "K3 compact")
    plain_ms = timed_ms(lambda: compact_kernel.compact_rows_reference(*args))
    b, n = keep.shape
    kept = int(counts.sum())
    nbytes = b * n + 8 * 2 * kept + 4 * b
    ops = OPS_PER_ELEMENT["compact"] * b * n
    bound_s, bound_by = bound(nbytes, ops)
    old_s, _ = bound(b * n * (2 * 4 + 1) + b * cap * 2 * 4 + 4 * b, ops)
    tile, threads = compact_kernel.launch_shape()
    tiles = b * -(-n // tile)
    first = FIRST_BUILD_MS["compact"]
    groups = ", ".join(f"{g} {t:.4f} ({k:g})"
                       for g, (t, k) in prof["groups"].items())
    log(f"phase 5: compact ({b} x {n} rows, 2 planes -> {cap}; {kept} kept): "
        f"{ms:.4f} ms (first build {first} ms, {first / ms:.1f}x), device: "
        f"kernel {dev_ms:.4f} ms, whole call busy {prof['busy_ms']:.4f} ms "
        f"({groups}), kernel with no row kept {empty_ms:.4f} ms; plain "
        f"{plain_ms:.3f} ms; bound {bound_s * 1e3:.5f} ms ({bound_by}: "
        f"keep, the kept rows' values, counts), share "
        f"{bound_s * 1e3 / dev_ms:.3f} of the kernel; the first build's "
        f"formula {old_s * 1e3:.5f} ms, share {old_s * 1e3 / dev_ms:.3f}; "
        f"launch: {tiles} blocks of {threads} threads ({tile} rows a "
        f"block) and the zeroing of {tiles + 1} "
        f"status words; ptxas: {ptxas_of('compact_kernel')}; on {card}")
    return (dict(err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
                 device_ms=dev_ms, busy_ms=prof["busy_ms"],
                 device_ms_none_kept=empty_ms, rows=n, lanes=b, kept=kept,
                 cap=cap), (pk_c, pf_c), counts)


def _place_fill_time(pix_before, emits, n_cap, where, card):
    """K2 on its path's rows against its plain version on the whole
    output, both timed; the bound counts the windowed placement's work."""
    args = (pix_before, emits, n_cap)
    err = selfcheck.max_abs_err(place_kernel.place_fill(*args),
                                place_kernel.place_fill_reference(*args))
    expect(err == 0, f"place_fill disagrees with its plain version ({where})")
    ms = timed_ms(lambda: place_kernel.place_fill(*args))
    dev_ms = device_ms(lambda: place_kernel.place_fill(*args),
                       "K2 place_fill")
    plain_ms = timed_ms(lambda: place_kernel.place_fill_reference(*args))
    b, q = pix_before.shape
    nbytes = 8 * b * q + 4 * b * n_cap
    ops = b * (WINDOW_OPS_PER_ROW * q + WINDOW_OPS_PER_PIXEL * n_cap)
    bound_s, bound_by = bound(nbytes, ops)
    first = FIRST_BUILD_MS[f"place_fill {where}"]
    log(f"phase 5: place_fill on the {where} path ({b} x {q} rows -> "
        f"{n_cap} px, {b * n_cap // place_kernel.WIN} windows): "
        f"{ms:.4f} ms (device {dev_ms:.4f}; first build {first} ms, "
        f"{first / ms:.1f}x), "
        f"plain {plain_ms:.3f} ms, bound {bound_s * 1e3:.5f} ms "
        f"({bound_by}), whole output equal to the plain version, on {card}")
    return dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bytes=nbytes, ops=ops, bound_ms=bound_s * 1e3, rows=q,
                images=b, n_cap=n_cap)


def phase5_split_kernels(run, launches, card):
    """K5 on the sparse split stream's rows from the round-0 guess, and K2
    on its lanes; returns K5's row and K2's split timing."""
    dec = run["dec"]
    (regions, _, chunks_sizes, px_budgets, _, _, _, qb, n_cap,
     qc) = dec.stage_plan(run["plan"])
    meta_t, val_t, pix_before = split.lane_rows(regions, chunks_sizes,
                                                px_budgets, qb, n_cap, qc)
    carry = split.initial_guess(meta_t.shape[1], meta_t.device)
    row = _replay_row("replay_summary", meta_t, val_t, carry, launches, card,
                      "split sparse, one fixpoint round")
    emits = replay_kernel.replay_batch_summary(meta_t, val_t,
                                               *carry)[0].T.contiguous()
    return row, _place_fill_time(pix_before, emits, n_cap, "split", card)


def phase5_replay_probe(run, sparse, rows, card):
    """The class probe (benchmarks/replay_probe): K1 at the batch RGB
    cell's shape and K5 at one split sparse round's, on all-NOP, all-SETA,
    all-ADD and all-IDX rows and the cells' own rows, in ns a row; kept in
    the two kernels' rows."""
    dev = run["streams"].device
    k1_meta, k1_val, _ = run["pipe"].replay_inputs(run["streams"],
                                                   run["sizes"])
    (regions, _, chunks_sizes, px_budgets, _, _, _, qb, n_cap,
     qc) = sparse["dec"].stage_plan(sparse["plan"])
    k5_meta, k5_val, _ = split.lane_rows(regions, chunks_sizes, px_budgets,
                                         qb, n_cap, qc)
    log(f"phase 5: the replay class probe on {card}")
    probe = replay_probe.run_probe(
        k1_meta, k1_val, k5_meta, k5_val,
        split.initial_guess(k5_meta.shape[1], dev), dev, runs=5)
    for row in rows:
        if row["name"] in ("replay", "replay_summary"):
            row["class_probe"] = [
                {k: p[k] for k in ("rows", "state_rows", "ms", "ns_per_row")}
                for p in probe if p["kernel"] == row["name"]]


def phase5_logfill(run, launches, dev, card):
    """K6 on the one-shot RGB decode's flagged words, event and device
    time; its launch configuration logged."""
    emits, real, produced, pix_before, n_cap = dec_ops.expansion_inputs(
        run["blob"], run["desc"], dev)
    words = dec_ops.flagged_words(emits, real, produced, pix_before, n_cap)
    err = selfcheck.max_abs_err(
        replay_kernel.logfill_batch(words),
        replay_kernel.logfill_batch_reference(words))
    expect(err == 0, "logfill disagrees with its plain version")
    ms = timed_ms(lambda: replay_kernel.logfill_batch(words))
    dev_ms = device_ms(lambda: replay_kernel.logfill_batch(words),
                       "K6 logfill")
    plain_ms = timed_ms(lambda: replay_kernel.logfill_batch_reference(words))
    # one compare per word in reach of each word's nearest flag (at most
    # 64): what a backward search reads
    col = torch.arange(words.shape[1], device=dev)
    last = torch.cummax(torch.where(words < 0, col, -(1 << 20)), 1).values
    reads = int(torch.clamp(col - last + 1, max=64).sum())
    b, n = words.shape
    per_block = replay_kernel.LOGFILL_SEGMENT * replay_kernel.LOGFILL_WARPS
    row = _kernel_row("logfill", launches["logfill"], err, ms, plain_ms,
                      8 * b * n, reads, words=b * n, device_ms=dev_ms)
    log(f"phase 5: logfill ({b} x {n} words, {reads / words.numel():.2f} "
        f"reads/word): {ms:.4f} ms, device {dev_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}), share {row['bound_ms'] / dev_ms:.3f}; launch: "
        f"grid {-(-n // per_block)} x {b} blocks of "
        f"{32 * replay_kernel.LOGFILL_WARPS} threads "
        f"({replay_kernel.LOGFILL_SEGMENT} words a warp); ptxas: "
        f"{ptxas_of('logfill_kernel')}; on {card}")
    return row


def _fields_time(packed, v, prev_in, run_in, seen_in, what, card):
    """E1 on one input against its plain version, both timed; its launch
    configuration logged.  Returns (err, ms, device_ms, plain_ms,
    bound_ms)."""
    args = (packed, v, 3, prev_in, run_in, seen_in)
    err = max(selfcheck.max_abs_err(g, w) for g, w in zip(
        fields_kernel.encode_fields_planes(*args),
        fields_kernel.encode_fields_planes_reference(*args)))
    lanes, n = packed.shape
    expect(err == 0, f"fields disagrees with its plain version at {lanes} "
           f"x {n}")
    ms = timed_ms(lambda: fields_kernel.encode_fields_planes(*args))
    dev_ms = device_ms(lambda: fields_kernel.encode_fields_planes(*args),
                       "E1 fields")
    plain_ms = timed_ms(
        lambda: fields_kernel.encode_fields_planes_reference(*args))
    npx = lanes * n
    bound_s, _ = bound(12 * npx, OPS_PER_ELEMENT["fields"] * npx)
    sms = torch.cuda.get_device_properties(packed.device).multi_processor_count
    seg_tiles, nseg = fields_kernel.segments(lanes, n, sms)
    first = FIRST_BUILD_MS.get(f"fields {lanes} x {n}")
    log(f"phase 5: fields ({what}, {lanes} x {n} px): {ms:.4f} ms, device "
        f"{dev_ms:.4f} ms, {npx / dev_ms / 1e3:.1f} MPix/s (first build "
        f"{'not timed' if first is None else f'{first} ms'}); plain "
        f"{plain_ms:.4f} ms; bound {bound_s * 1e3:.5f} ms; launch: "
        f"{nseg} segment(s) a row of {seg_tiles} tile(s), grid {lanes} x "
        f"{nseg} blocks of {fields_kernel.SEG_TILE} threads on {sms} SMs"
        f"{', summaries first' if nseg > 1 else ''}, on {card}")
    return err, ms, dev_ms, plain_ms, bound_s * 1e3


def phase5_fields(sparse, batch, launches, dev, card):
    """E1 against its plain version at the two encode-window shapes of the
    4096x4096 image's first window (1 x 2^18 pixels, and 16 lanes x 2^16
    with their closed-form carries), both timed, and, logged only, on the
    first FIELDS_BATCH images of the batch RGB corpus from the start
    state; bound: 4 bytes read and 8 written per pixel."""
    times = []
    for lanes, n in FIELDS_SHAPES:
        packed = pixels_to_packed(torch.from_numpy(
            sparse["raw"][: lanes * n * 3]).to(dev), 3).reshape(lanes, n)
        prev0, run0, seen0 = fields_kernel.start_state(1, dev)
        v, prev_in, run_in, seen_in = device_stream.lane_carries(
            packed, lanes * n, prev0[0], run0[0], seen0[:, 0])
        times.append(_fields_time(packed, v, prev_in, run_in, seen_in,
                                  "stream encode", card))
    packed = batch["packed_in"][:FIELDS_BATCH].contiguous()
    v = torch.full((FIELDS_BATCH,), batch["pipe"].n_px, dtype=torch.int32,
                   device=dev)
    err_b, ms_b, dev_b, plain_b, bound_b = _fields_time(
        packed, v, *fields_kernel.start_state(FIELDS_BATCH, dev),
        "batch RGB, log only", card)
    ((err, ms, dev_ms, plain_ms, _),
     (err_l, ms_l, dev_ms_l, plain_l, bound_l)) = times
    npx = FIELDS_SHAPES[0][0] * FIELDS_SHAPES[0][1]
    return _kernel_row(
        "fields", launches["fields"], max(err, err_l, err_b), ms, plain_ms,
        12 * npx, OPS_PER_ELEMENT["fields"] * npx, device_ms=dev_ms,
        lanes=1, pixels=npx, ms_lanes=ms_l, device_ms_lanes=dev_ms_l,
        plain_ms_lanes=plain_l, bound_ms_lanes=bound_l,
        lanes_shape=list(FIELDS_SHAPES[1]),
        ms_batch=ms_b, device_ms_batch=dev_b, plain_ms_batch=plain_b,
        bound_ms_batch=bound_b,
        batch_shape=list(packed.shape))


def _time_path(what, fn, mpix, card):
    cold = timed_ms(fn, warmup=0, runs=1)
    ms = timed_ms(fn, warmup=3, runs=5)
    log(f"phase 5: {what}: {ms:.2f} ms = {mpix / ms * 1e3:.1f} MPix/s "
        f"(cold {cold:.2f} ms) on {card}")


def _variants(rows):
    """An experiment main's result rows without their parity fields."""
    return [{k: v for k, v in r.items() if not k.endswith("err")}
            for r in rows]


def _worst(err, rows):
    """err and every compared variant's max_abs_err, the largest."""
    return max([err] + [r["max_abs_err"] for r in rows
                        if r["max_abs_err"] is not None])


def phase5_window(name, results, launches, dev, card):
    """A windowed placement kernel (its wrapper's defaults) against its
    plain version on its experiment's main input, timed beside K2 and the
    plain version, base rows computed outside the timed call; bound: 8
    bytes read per row, 4 written per pixel."""
    _, make, lanes, wrapper = EXPERIMENTS[name]
    case, pb_np, em_np, n_cap = make()
    pb = torch.from_numpy(pb_np).to(dev)
    em = torch.from_numpy(em_np.view(np.int32)).to(dev)
    del pb_np, em_np
    base = place_window.window_base_rows_w(pb, n_cap, lanes)
    call = lambda: wrapper(pb, em, base, n_cap)
    err = selfcheck.max_abs_err(
        call(), place_kernel.place_fill_reference(pb, em, n_cap))
    expect(err == 0, f"{name} disagrees with its plain version")
    plain = lambda: place_kernel.place_fill_reference(pb, em, n_cap)
    k2 = lambda: place_kernel.place_fill(pb, em, n_cap)
    plain_ms = timed_ms(plain, warmup=1, runs=3)
    ms = timed_ms(call)
    k2_ms = timed_ms(k2)
    b, q = pb.shape
    log(f"phase 5: {name} ({case}: {b} x {q} rows -> {n_cap} px): "
        f"{ms:.4f} ms, K2 {k2_ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
    extra = {}
    if name != "place_wide":
        windows = b * n_cap // place_kernel.WIN
        extra = _beside_k2(
            name, call, k2, "E2/E3/E5/E6 windowed placement",
            windows // 2 if name == "place_fill2" else windows,
            {"place_fill2": "place_fill2_kernel",
             "place_fill_narrow": "place_narrow_kernel",
             "place_variant": "place_variant_kernelILb1ELb1ELi6E"}[name],
            card)
    if name == "place_fill2":
        extra["long_fill_share"] = expt_place2.long_fill_share(pb, n_cap)
        log(f"phase 5: place_fill2: long search in "
            f"{extra['long_fill_share']:.4f} of the windows")
    if name == "place_variant":
        log_variant_loads()
    return _kernel_row(
        name, launches[name], _worst(err, results[name]), ms, plain_ms,
        8 * b * q + 4 * b * n_cap,
        b * (WINDOW_OPS_PER_ROW * q + WINDOW_OPS_PER_PIXEL * n_cap),
        case=case, rows=q, images=b, n_cap=n_cap, k2_ms=k2_ms,
        variants=_variants(results[name]), **extra)


def log_variant_loads():
    """Log the global loads (LDG) in the SASS of each E6 instantiation and
    require every one that reads rows (do_dma) to hold more of them than
    the one at the same n_fill that reads none: the instantiations that
    read rows they never place must still read them."""
    loads, name = {}, None
    for line in kernels.sass("place_variant_kernel").splitlines():
        if "Function :" in line:
            m = re.search(r"place_variant_kernelILb(\d)ELb(\d)ELi(\d)E", line)
            name = tuple(int(x) for x in m.groups())
            loads[name] = 0
        elif name is not None and re.search(r"\bLDG\b", line):
            loads[name] += 1
    log("phase 5: place_variant: LDG instructions in the SASS (do_dma, "
        "do_slabs, n_fill): " + ", ".join(
            f"{k}: {v}" for k, v in sorted(loads.items())))
    expect(len(loads) == 21, f"SASS of {len(loads)} E6 instantiations")
    for (dma, slabs, fill), n in loads.items():
        if dma:
            expect(n > loads[(0, 0, fill)], f"E6 ({dma}, {slabs}, {fill}) "
                   "lost its row loads")


def _beside_k2(name, call, k2, group, blocks, entry, card):
    """E3-E6's device time (profiler group ``group``) and K2's on the
    same input, returned as kernel row fields; logged with the kernel's
    launch configuration and ptxas report (its kernel entries whose names
    hold ``entry``), which stay out of the row."""
    dev_ms = device_ms(call, group)
    k2_dev_ms = device_ms(k2, "K2 place_fill")
    threads, per_sm = place_window.launch_shape(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launch = (f"{blocks} blocks of {threads} threads, {per_sm} resident an "
              f"SM on {sms} SMs ({blocks / (per_sm * sms):.1f} waves)")
    log(f"phase 5: {name}: device {dev_ms:.4f} ms, K2 device "
        f"{k2_dev_ms:.4f} ms ({dev_ms / k2_dev_ms:.3f}x K2); launch: "
        f"{launch}; ptxas: {ptxas_of(entry)}; on {card}")
    return dict(device_ms=dev_ms, k2_device_ms=k2_dev_ms)


def phase5_place_grouped(results, launches, dev, card):
    """E4 at its wrapper's defaults (8192-pixel windows, G=1, dyn) on its
    script's main input against the plain version, timed beside K2 and the
    plain version, base rows outside the timed call; bound: 8 bytes read
    per row, 4 written per pixel."""
    pb_np, em_np, _ = expt_place.gen_inputs(
        np.random.default_rng(0), expt_place.B, expt_place.N_CAP,
        expt_place.CAP)
    pb = torch.from_numpy(pb_np).to(dev)
    em = torch.from_numpy(em_np.view(np.int32)).to(dev)
    del pb_np, em_np
    n_cap = expt_place.N_CAP
    base = place_window.step_base_rows(pb, n_cap, place_window.WIN)
    call = lambda: place_window.place_grouped(pb, em, base, n_cap)
    plain = lambda: place_window.summed_place_reference(pb, em, n_cap)
    err = selfcheck.max_abs_err(call(), plain())
    expect(err == 0, "place_grouped disagrees with its plain version")
    plain_ms = timed_ms(plain, warmup=1, runs=3)
    ms = timed_ms(call)
    k2 = lambda: place_kernel.place_fill(pb, em, n_cap)
    k2_ms = timed_ms(k2)
    b, q = pb.shape
    # the rows the dyn kernel reads: each window's slabs from the first
    # whose last pb reaches it to the last whose first pb lies below its end
    slabs = pb.view(b, -1, place_window.SLAB)
    edges = torch.arange(0, n_cap + 1, place_window.WIN, device=dev,
                         dtype=torch.int32).expand(b, -1)
    s0 = torch.searchsorted(slabs[:, :, -1].contiguous(),
                            edges[:, :-1].contiguous())
    e = torch.searchsorted(slabs[:, :, 0].contiguous(),
                           edges[:, 1:].contiguous())
    read = int((e - s0).clamp(min=0).sum()) * place_window.SLAB
    log(f"phase 5: place_grouped (main: {b} x {q} rows -> {n_cap} px): "
        f"{ms:.4f} ms, K2 {k2_ms:.4f} ms, plain {plain_ms:.4f} ms; reads "
        f"{read} rows, {read / (b * q):.4f} of the rows; on {card}")
    extra = _beside_k2("place_grouped", call, k2, "E4 grouped placement",
                       b * n_cap // place_kernel.WIN,
                       "place_grouped_kernelILi1E", card)  # lr_mode dyn
    rows = results["place_grouped"]
    return _kernel_row(
        "place_grouped", launches["place_grouped"], _worst(err, rows), ms,
        plain_ms, 8 * b * q + 4 * b * n_cap,
        b * (WINDOW_OPS_PER_ROW * q + WINDOW_OPS_PER_PIXEL * n_cap),
        case=f"main B={b}", rows=q, images=b, n_cap=n_cap, k2_ms=k2_ms,
        variants=_variants(rows), **extra)


def phase5_emit_window(results, launches, dev, card):
    """E7 at its wrapper's defaults (256 lanes) on its script's input
    against the plain version, timed beside K4 and the plain version, base
    rows outside the timed call; bound: 12 bytes read per row, 4 written
    per output byte."""
    off_np, tlo_np, thn_np, out_cap = expt_emit_wide.gen_inputs(
        np.random.default_rng(0), 8, 1 << 17)
    off = torch.from_numpy(off_np).to(dev)
    tlo, thn = (torch.from_numpy(x.view(np.int32)).to(dev)
                for x in (tlo_np, thn_np))
    base = emit_window.window_base_rows_w(off, out_cap, 256)
    call = lambda: emit_window.emit_wide(off, tlo, thn, base, out_cap)
    plain = lambda: emit_window.emit_wide_reference(off, tlo, thn, out_cap)
    err = selfcheck.max_abs_err(call(), plain())
    expect(err == 0, "emit_window disagrees with its plain version")
    plain_ms = timed_ms(plain)
    ms = timed_ms(call)
    k4_ms = timed_ms(lambda: emit_kernel.emit_bytes(off, tlo, thn, out_cap))
    b, c = off.shape
    log(f"phase 5: emit_window (8 x {c} rows -> {out_cap} bytes): "
        f"{ms:.4f} ms, K4 {k4_ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
    rows = results["emit_window"]
    return _kernel_row(
        "emit_window", launches["emit_window"], _worst(err, rows), ms,
        plain_ms, 12 * b * c + 4 * b * out_cap,
        OPS_PER_ELEMENT["emit"] * b * out_cap, rows=c, images=b,
        out_cap=out_cap, k4_ms=k4_ms, variants=_variants(rows))


def phase5_probes(results, launches, card):
    """E8 at 65,536 steps and E9 at 2,048 blocks, from the probes' run;
    bounds: E8 8 bytes per word, E9 8 per target read and 4 per bin
    written."""
    grid = results["probes"]["grid_step"]
    g = grid[-1]
    words = g["steps"] * probes.STEP_SHAPE[0] * probes.STEP_SHAPE[1]
    o = results["probes"]["onehot_place"]
    nbins = o["s"] * 128
    log(f"phase 5: grid_step ({g['steps']} steps): {g['ms']:.4f} ms, x + 1 "
        f"{g['library_ms']:.4f} ms; onehot_place ({o['blocks']} x {o['k']} "
        f"targets): {o['ms']:.4f} ms, scatter_add_ {o['library_ms']:.4f} ms "
        f"on {card}")
    return [
        _kernel_row("grid_step", launches["grid_step"], g["max_abs_err"],
                    g["ms"], g["plain_ms"], 8 * words, words,
                    library_ms=g["library_ms"], steps=g["steps"],
                    by_steps=[{k: r[k] for k in ("steps", "ms", "plain_ms",
                                                 "library_ms")}
                              for r in grid]),
        _kernel_row("onehot_place", launches["onehot_place"],
                    o["max_abs_err"], o["ms"], o["plain_ms"],
                    8 * o["blocks"] * o["k"] + 4 * o["blocks"] * nbins,
                    o["blocks"] * o["k"], library_ms=o["library_ms"],
                    blocks=o["blocks"], targets=o["k"], bins=nbins)]


def phase5_pipeline_times(run, card):
    pipe, b = run["pipe"], len(run["blobs"])
    mpix = b * pipe.n_px / 1e6
    _time_path(f"decode_packed[{run['label']}] B={b}",
               lambda: pipe.decode_packed(run["streams"], run["sizes"]),
               mpix, card)
    _time_path(f"encode_packed_chunked[{run['label']}] B={b}",
               lambda: pipe.encode_packed_chunked(run["packed_in"], sub=8),
               mpix, card)


def phase5_split_times(run, card):
    dec, d = run["dec"], run["desc"]
    mpix = d.width * d.height / 1e6
    staged = dec.stage_plan(run["plan"])
    what = (f"split {run['label']} {d.width}x{d.height} L={SPLIT_LANES} "
            f"rounds={run['rounds']}")
    _time_path(f"{what} decode_to_device",
               lambda: dec.decode_to_device([run["blob"]]), mpix, card)
    _time_path(f"{what} dispatch_staged",
               lambda: dec.dispatch_staged(staged), mpix, card)


def phase5_oneshot_times(runs, card):
    for run in runs:
        d = run["desc"]
        mpix = d.width * d.height / 1e6
        _time_path(f"decode_single[{run['label']}]",
                   lambda: backend.decode_single(run["blob"], d, d.channels,
                                                 device=run["dev"]),
                   mpix, card)
    run = runs[0]
    _time_path(f"encode_single[{run['label']}]",
               lambda: backend.encode_single(run["raw"], run["desc"],
                                             device=run["dev"]),
               run["desc"].width * run["desc"].height / 1e6, card)


def main():
    card = phase0_device()
    dev = torch.device("cuda")
    phase1_build()
    phase2_edge_cases(dev)
    runs = phase3_prepare(dev)
    split_runs = phase3_prepare_split(runs, dev)
    oneshot = phase3_prepare_oneshot(runs, dev)
    launches = {}
    drive("the batch path", lambda: phase3_main_path(runs),
          ("replay", "place_fill", "compact", "emit"), launches)
    sparse, dense = split_runs
    drive("the split path (sparse)", lambda: phase3_split(sparse),
          ("replay_summary", "compact", "place_fill"), launches)
    drive("the split path (dense)", lambda: phase3_split(dense),
          ("replay_summary", "place_fill"), launches)
    drive("the one-shot path (decode rgb)",
          lambda: phase3_oneshot_decode(oneshot[0]), ("replay", "logfill"),
          launches)
    drive("the one-shot path (decode rgba)",
          lambda: phase3_oneshot_decode(oneshot[1]), ("replay",), launches)
    drive("the one-shot path (encode rgb)",
          lambda: phase3_oneshot_encode(oneshot[0]), ("compact", "emit"),
          launches)
    streams = phase3_prepare_stream(runs, split_runs)
    for st in streams:
        drive(f"the streaming path ({st['label']})",
              lambda st=st: phase3_stream(st, dev),
              lambda st=st: _stream_needs(st), launches)
    results = {}
    for name in EXPERIMENTS:
        drive(f"the {name} experiment", lambda name=name: phase3_experiment(
            name, results, dev), (name,), launches)
    drive("the expt_place (E4) experiment",
          lambda: phase3_expt_place(results, dev), ("place_grouped",),
          launches)
    drive("the expt_emit_wide (E7) experiment",
          lambda: phase3_expt_emit_wide(results, dev), ("emit_window",),
          launches)
    drive("the profile_r2 probes (E8, E9)",
          lambda: phase3_probes(runs[0], results, dev),
          ("grid_step", "onehot_place"), launches)
    log(f"phase 4: launches over all paths: {launches}")
    rows = phase5_kernels_at_main_shapes(runs[0], launches, card)
    k5, k2_split = phase5_split_kernels(sparse, launches, card)
    rows.append(k5)
    k2 = next(r for r in rows if r["name"] == "place_fill")
    k2.update({f"{k}_split": k2_split[k] for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "rows", "images",
        "n_cap")})
    phase5_replay_probe(runs[0], sparse, rows, card)
    rows.append(phase5_logfill(oneshot[0], launches, dev, card))
    rows.append(phase5_fields(sparse, runs[0], launches, dev, card))
    for name in EXPERIMENTS:
        rows.append(phase5_window(name, results, launches, dev, card))
    rows.append(phase5_place_grouped(results, launches, dev, card))
    rows.append(phase5_emit_window(results, launches, dev, card))
    rows.extend(phase5_probes(results, launches, card))
    for run in runs:
        phase5_pipeline_times(run, card)
    for run in split_runs:
        phase5_split_times(run, card)
    phase5_oneshot_times(oneshot, card)
    for st in streams:
        d = st["im"]["desc"]
        _time_path(st["label"], lambda st=st: _stream_session(st, dev),
                   d.width * d.height / 1e6, card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
