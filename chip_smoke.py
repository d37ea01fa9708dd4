#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qoipp_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

0. prints the card (nvidia-smi name and power limit), torch and CUDA;
1. builds the sixteen CUDA kernels from qoipp_tpu_torch/csrc (the fifteen
   that replace the JAX package's Pallas kernels and the chunk-start scan;
   fourteen sources, one nvcc each, started together) and the native
   oracle from native/qoi_ref.cpp;
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
   - the serving path (models/serving.ServingCodec at its defaults) on the
     committed real corpus, tests/resources/local_corpus/*.qoi (16 images,
     9.31 MPix), replicated 8 times as benchmarks/serving_bench.py's
     default does (128 requests, 74.5 MPix): decode_dispatch ->
     decode_finish, encode, a resident corpus decoded twice,
     decode_dispatch_overlapped and encode_stage -> encode_dispatch_staged,
     every request against the oracle's pixels and bytes, the routes
     logged (packed tiers, the split group, the geometry buckets); then
     PackedDecoder and PackedEncoder alone on the same 128 requests, and
     api's torch backend (decode and encode) on photo_china_1080p and an
     RGBA icon against its native backend;
   - the parallel layer (qoipp_tpu_torch.parallel) as jobs of local ranks
     that share the one card (parallel.launch.run_ranks; the kernels built
     in phase 1, the exchange through gloo staged in host memory): dp at 2
     ranks on a (2, 1) mesh, the batch RGB corpus 8 images a rank decoded
     by make_dp_decode (with the checksum) and the pixels re-encoded by
     make_dp_encode, each image against the oracle; sp at 4 ranks on a
     (1, 4) mesh, make_sp_decode of the 4096x4096 sparse stream and of the
     committed photo_china_1080p at 24 tiles a rank (96 tiles, as
     SplitDecoder(96)), the blocks gathered, expanded and held to the
     oracle's pixels, each decode's fixpoint rounds logged, and
     make_sp_encode of the 4096x4096 raw image (4,194,304 px a shard) and
     of the 1310x1191 RGBA screenshot (its last shard 389,970 of 390,080
     px), the bodies joined against the oracle's stream; and the dp job
     at world 1 through NCCL (two ranks on one card are refused by NCCL);
4. requires each kernel of each path to have launched in that path's run
   (counts set to 0 just before each run and read just after; a parallel
   path's counts are its ranks', each taken over the path's run alone and
   summed), the chunk-start scan on every decode path;
5. checks each kernel against its plain version again at its path's
   shapes and times both (E2-E6 beside K2, E7 beside K4 on the same
   inputs, E2-E6 also in device time beside K2's and E7 beside K4's, with
   their launch configuration and ptxas report, E2 and E7 beside their
   first build's device time, E7 also on its script's rows at fill 0.999,
   whose trailing run of equal offs is ~130 rows, not ~32,770, and with
   the bound of what it must move beside that of every row; E3 with the
   share of its windows that
   take the long search, E6 with the global loads in the SASS of each
   instantiation, so that those which read rows they do not place show
   that they still read them; E8 and E9 from the probes' run, beside their
   torch calls; K2 on
   the batch and the split path's whole output and E1 at both
   stream-encode shapes and, logged only, at 8 batch RGB images, each
   also in device time (torch.profiler) and beside its first build's
   time; the chunk-start scan on 128 rows of the batch RGB regions
   (batch1080_decode's shape) and on one 1 MiB window of the streaming
   decoder (the (96, qb + 8) plane's view), event, device and plain ms,
   its bound (2 bytes a byte) and the device ops a call; K3 as the whole
   compact_rows call (device time by kernel group,
   beside its first build's time) and K6 also in device time, both with
   their launch configuration and ptxas report; the batch encoder on the
   batch RGB corpus at the default and at tight caps (chunk_cap under
   n_px), held against the compact-first chain, with the scan tight caps
   add (nth_chunk) alone, logged only; K1 and K5 on the first
   and on the last 4,096 rows, the last from the kernel's own carry,
   timed beside the first build's time and their chain bound: the
   longest chain of dependent operations the function needs on those
   rows, at the dependent-issue latency and SM clock the card shows in
   the same run), runs the replay class probe
   (benchmarks/replay_probe: K1 at 16 x 277,888 rows and K5 at 96 x
   12,288 on all-NOP, all-SETA, all-ADD and all-IDX rows and the cells'
   own, in ns a row); holds every kernel of the serving path, the packed
   lanes and the api backend against its plain version at each shape
   those paths give it (K1 and K2 on every packed decode tier and on
   PackedDecoder's plan, K1 also on the 4,096 rows over the first stream
   reset inside a lane, from the kernel's own carry; K3, K5 at every
   fixpoint round and K2 on the split group; K3's two compactions and K4
   on every packed encode tier and on PackedEncoder's lanes; E1, K3 and
   K4 on every geometry bucket; K1, K6, E1, K3 and K4 on api's images: the
   rows' "held_at"), and times K1 and K2 on the first decode tier and K3
   and K4 on the first encode tier beside their plain versions; then
   times every path (1 cold, 3 warmup, 5 timed runs, CUDA
   events), the serving path as decode to completion, pre-staged,
   resident, overlapped and end to end with the fetch, encode to
   completion, pre-staged and end to end, and the packed lanes alone; in
   the parallel jobs' ranks, holds K5 on the first and the last 4,096
   rows of rank 0's tiles from the last fixpoint round's in-state (the
   tail from the kernel's own carry) and E1, K3 and K4 on every sp-encode
   shard with its exchanged carries, each on the arguments the path gave
   it (the rows' "held_at"), and times every parallel path by the host
   clock between barriers (1 first call, 3 warmup, 5 timed), in ms and
   MPix/s, logged as ranks sharing one card;
6. the tools phase: the port's tools and examples as a user runs them,
   each path's launches counted alone: the differential fuzzer
   (qoipp_tpu_torch.tools.fuzz, seed 0, 30 rounds of its eight targets at
   random shapes, every result against the oracle), tools.bench over the
   committed real corpus and over the batch RGB corpus (its enc x dec
   cross matrix first, the torch-batch row on the second) and its
   one-shot --sizes sweep (512x512, 1920x1080, 3840x2160, native against
   torch), examples.ingest_pipeline at --batch 16 on the batch RGB corpus
   (decoded pixels against the oracle, features against fp32) and
   examples.serving_codec, bench at one timed call a cell (its timed
   table is `python -m qoipp_tpu_torch.tools.bench`'s own run); every
   launch goes through a watched wrapper, and after each path a sample of
   its calls a kernel (the first, the largest, the first at the last
   shape, every K6 call) is held against the plain version on copies of
   its arguments (K1 and K5 as above, from the kernel's own carry: the
   rows' "held_at"); the phase must launch and hold K1-K6 and E1, and
   its counts join the kernel table's launches ("tools_launches" alone);
7. the profiles phase, in a process of its own (a long process's
   torch.profiler drops device events): the stage profiles and
   host-stage experiments of qoipp_tpu_torch/benchmarks, each timed
   (CUDA events; device ms and
   launches by torch.profiler) after it holds its results, through the
   same watched wrappers and sampled holds as phase 6: profile_r3 on the
   batch RGB and RGBA corpora (each decode stage and each encode stage
   alone, their sum beside the fused call, the last stage's output
   against the fused call's and the oracle's), profile_bucket_decode
   (the real corpus's over-cap streams x 8 by geometry),
   profile_packed_decode and profile_packed_encode (real-corpus packed
   lanes), expt_boundary2l (the two-level boundary scan against the
   shipped one on the script's byte soup and the batch RGB regions,
   timed at B=128 x 749,568 bytes), expt_table_stack (both stacked table
   fills against the shipped sort-based scans, timed at 12 x 458,752 and
   32 x 524,288 rows), expt_compact (K3 at 12 x 917,504 rows against its
   plain version), expt_enc_lanes (the packed encoder at 8, 16 and 32
   lanes against the oracle) and expt_h2d_chunks (a 54 MB payload in 1 to
   256 pieces: pageable, pinned, stage_h2d and D2H MB/s); then every
   engine that stages through utils/transport.stage_h2d at 1 MB chunks
   (SplitDecoder, the streaming decoder, PackedDecoder, PackedEncoder,
   ServingCodec) against the oracle, each with at least one upload cut
   into pieces; the phase must launch and hold K1-K4, and its counts join
   the kernel table's launches ("profiles_launches" alone).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure raises, so the script exits
non-zero with no final line; so does a machine without a CUDA device.
It imports neither JAX nor the JAX package.
"""

import sys

for _name in ("jax", "qoipp_tpu", "bench", "benchmarks"):
    sys.modules[_name] = None  # the port runs where these are absent

import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pickle  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from qoipp_tpu_torch import api, kernels, oracle  # noqa: E402
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
from qoipp_tpu_torch.common import Channels, Desc, read_header  # noqa: E402
from qoipp_tpu_torch.kernels import selfcheck  # noqa: E402
from qoipp_tpu_torch.models import packed as packed_lanes  # noqa: E402
from qoipp_tpu_torch.models import serving, split  # noqa: E402
from qoipp_tpu_torch.models.pipeline import BatchPipeline  # noqa: E402
from qoipp_tpu_torch.ops import (  # noqa: E402
    backend,
    boundary,
    compact_kernel,
    decode as dec_ops,
    device_stream,
    emit_kernel,
    emit_window,
    encode as enc_ops,
    fields_kernel,
    gather_kernel,
    place_kernel,
    place_window,
    probes,
    replay_kernel,
)
from qoipp_tpu_torch.ops.bitops import pixels_to_packed  # noqa: E402
from qoipp_tpu_torch.parallel import dryrun, launch  # noqa: E402
from qoipp_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from qoipp_tpu_torch.parallel import sharded  # noqa: E402
from qoipp_tpu_torch.utils import profile, transport  # noqa: E402
from qoipp_tpu_torch.utils.corpus import make_corpus, make_image  # noqa: E402

W, H = 1920, 1088
CORPORA = (("rgb", 16, 0, 3), ("rgba", 8, 7, 4))  # label, B, seed, channels
SPLIT_SIDE = 4096  # the sparse split stream is SPLIT_SIDE x SPLIT_SIDE RGB
SPLIT_LANES = 96  # SplitDecoder's serving default
PLAIN_REPLAY_ROWS = 4096  # the plain replay loop runs 0.2-0.4 ms per row
# the kernels as first built, ms a call at the shapes phase 5 times, on an
# H100 80GB HBM3 at 700 W (PERF.md §6): K1 and K5 one thread a lane, 32
# lanes a block; K2 a binary search a pixel; E1 one block a row; K3 (the
# whole compact_rows call) a torch.cumsum and a scatter a row; E2 and E7
# (device ms) lanes rows staged a step with two block syncs each
FIRST_BUILD_MS = {"replay": 51.143, "replay_summary": 2.113,
                  "place_fill batch": 1.158, "place_fill split": 0.722,
                  "fields 1 x 262144": 0.4419, "fields 16 x 65536": 0.1135,
                  "compact": 3.469, "place_wide": 0.0818,
                  "emit_window": 0.0915}
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
    "chunk_starts": ("qoipp_tpu_torch/csrc/boundary.cu",
                     "none: qoipp_tpu/ops/boundary.py scans in plain JAX"),
    "gather_pixels": ("qoipp_tpu_torch/csrc/gather.cu",
                      "none: qoipp_tpu/models/packed.py unpacks on the host"),
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
# the chunk-start scan's phase 5 shapes: batch1080_decode's rows (the batch
# RGB corpus's regions repeated) and one streaming decoder window
SCAN_BATCH = 128
SCAN_WINDOW = 1 << 20
CORPUS_DIR = Path(__file__).resolve().parent / "tests" / "resources" / \
    "local_corpus"
CORPUS_STREAMS = 16  # the committed real corpus
SERVING_REPLICATE = 8  # benchmarks/serving_bench.py's default --replicate
# PackedDecoder and PackedEncoder alone on the serving corpus: caps that
# hold its largest stream (2.8 MB body) and image (1920x1080)
PACKED_LANE_BYTES = 8 << 20
PACKED_LANE_PX = 1 << 21
API_IMAGES = ("photo_china_1080p", "icon_image")  # RGB: K6; RGBA
# the parallel phase: jobs of local ranks that share the one card (gloo,
# the exchange staged through host memory; NCCL only at world 1: two ranks
# on one card are refused as duplicate GPUs)
PARALLEL = dict(
    dp_world=2,  # mesh (2, 1): 8 of the batch RGB corpus's 16 images a rank
    sp_world=4,  # mesh (1, 4)
    sp_tiles=24,  # tiles a rank: 96 tiles, SplitDecoder(96)'s lanes
    sp_decode=("sparse", "photo_china_1080p"),
    sp_encode=("sparse", "screenshot_requests"),  # RGB 4096^2; RGBA uneven
    timeout=600,  # s a job
)


# the tools phase: the fuzzer's rounds of all eight targets (seed 0), the
# timed calls a bench cell, and the kernels the phase must launch (K1-K6
# and E1)
TOOLS_FUZZ_ITERATIONS = 30
TOOLS_NEEDS = ("replay", "place_fill", "compact", "emit", "replay_summary",
               "logfill", "fields")
# the profiles phase: timed calls a measurement of the stage profiles and
# experiments, the lane counts of the lane sweep (its script's 8-64, cut
# for time), the chunk size the staging engines run at, and the kernels
# the phase must launch and hold (K1-K4)
PROFILE_RUNS = 3
PROFILE_LANES = (8, 16, 32)
PROFILE_CHUNK_BYTES = 1 << 20
PROFILE_NEEDS = ("replay", "place_fill", "compact", "emit")


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
    """The kernels a streaming session must launch: decode the chunk-start
    scan, K5 and K2 (and K3 where a window took the chunk domain), encode
    E1, K3 and K4."""
    if s["kind"] == "encode":
        return ("fields", "compact", "emit")
    return ("chunk_starts", "replay_summary", "place_fill") + (
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


def phase3_prepare_serving(dev):
    """The serving corpus: the committed real corpus read from its files,
    each stream's oracle pixels and the oracle's stream of those pixels,
    replicated SERVING_REPLICATE times."""
    t0 = time.perf_counter()
    paths = sorted(CORPUS_DIR.glob("*.qoi"))
    expect(len(paths) == CORPUS_STREAMS, f"{CORPUS_DIR} holds {len(paths)} "
           f"streams, not {CORPUS_STREAMS}")
    files = [np.fromfile(p, np.uint8) for p in paths]
    descs = [read_header(b).value() for b in files]
    raws = [oracle.decode(b, d, d.channels) for b, d in zip(files, descs)]
    refs = [oracle.encode(r, d)[0] for r, d in zip(raws, descs)]
    k = SERVING_REPLICATE
    s = dict(names=[p.stem for p in paths] * k, blobs=files * k,
             descs=descs * k, raws=raws * k, refs=refs * k,
             codec=serving.ServingCodec(device=dev))
    s["mpix"] = sum(d.width * d.height for d in s["descs"]) / 1e6
    log(f"phase 3: serving corpus: {len(paths)} real images x {k} = "
        f"{len(s['blobs'])} requests, {s['mpix']:.2f} MPix, "
        f"{sum(b.size for b in s['blobs']) / 1e6:.2f} MB of streams (made "
        f"in {time.perf_counter() - t0:.1f} s)")
    return s


def _check_all(got, want, names, what):
    bad = sorted({n for g, w, n in zip(got, want, names)
                  if not np.array_equal(g, w)})
    expect(len(got) == len(want) and not bad,
           f"{what}: {bad or 'the count'} differ from the oracle")


def phase3_serving(s):
    """ServingCodec on the serving corpus, every request against the
    oracle: decode_dispatch -> decode_finish, encode, a resident corpus
    decoded twice, decode_dispatch_overlapped, encode_stage ->
    encode_dispatch_staged; the routes logged."""
    codec, blobs, raws, descs, names, refs = (
        s[k] for k in ("codec", "blobs", "raws", "descs", "names", "refs"))
    plan = codec.decode_dispatch(blobs)
    _, packed_parts, split_parts = plan
    routes = dict(
        decode_packed_tiers=[len(i) for i, _ in packed_parts],
        decode_packed_shapes=[list(p[0].shape) for _, p in packed_parts],
        decode_split_groups=[len(i) for i, _ in split_parts],
        decode_split_streams=sorted({names[i] for g, _ in split_parts
                                     for i in g}),
        decode_split_rounds=[p[3] for _, p in split_parts])
    _check_all(codec.decode_finish(plan), raws, names,
               "serving decode_dispatch -> decode_finish")
    _check_all(codec.encode(raws, descs), refs, names, "serving encode")
    s["resident"] = codec.make_resident(blobs)
    for k in (1, 2):
        _check_all(codec.decode_finish(s["resident"].decode_device()), raws,
                   names, f"resident decode_device, call {k}")
    _check_all(codec.decode_finish(codec.decode_dispatch_overlapped(blobs)),
               raws, names, "serving decode_dispatch_overlapped")
    staged = codec.encode_stage(raws, descs)
    routes.update(
        encode_packed_tiers=[len(i) for i, _ in staged[1]],
        encode_buckets=[f"{d.width}x{d.height}x{int(d.channels)}: "
                        f"{len(i)}" for i, _, _, d in staged[2]])
    _check_all(codec.encode_finish(codec.encode_dispatch_staged(staged)),
               refs, names, "serving encode_stage -> encode_dispatch_staged")
    s["routes"] = routes
    log(f"phase 3: serving routes: {routes}")
    log(f"phase 3: serving: decode_dispatch -> decode_finish, encode, "
        f"resident decode_device x 2, decode_dispatch_overlapped and "
        f"encode_stage -> encode_dispatch_staged equal the oracle on all "
        f"{len(blobs)} requests")


def phase3_packed(s, dev):
    """PackedDecoder and PackedEncoder alone on the serving corpus, every
    request against the oracle; their lane plans logged."""
    blobs, raws, descs, names, refs = (
        s[k] for k in ("blobs", "raws", "descs", "names", "refs"))
    dec = packed_lanes.PackedDecoder(lane_bytes=PACKED_LANE_BYTES, device=dev)
    regions, _, _, where, _, qb, n_cap, l_total = dec.plan_and_pack(blobs)
    per_lane = np.bincount([lane for lane, _ in where])
    log(f"phase 3: PackedDecoder: {len(blobs)} streams over "
        f"{len(per_lane)} lanes ({regions.shape[0]} uploaded, {l_total} on "
        f"the device), qb {qb}, n_cap {n_cap}, {per_lane.min()}.."
        f"{per_lane.max()} streams a lane")
    _check_all(dec.decode(blobs), raws, names, "PackedDecoder.decode")
    enc = packed_lanes.PackedEncoder(lane_px=PACKED_LANE_PX, device=dev)
    pk, _, ewhere, caps = enc.plan_and_pack(raws, descs)
    members = np.bincount([lane for lane, _ in ewhere])
    log(f"phase 3: PackedEncoder: {len(raws)} images over {pk.shape[0]} "
        f"lanes of {pk.shape[1]} pixels, {members.min()}..{members.max()} "
        f"streams a lane, caps {caps}")
    _check_all(enc.encode(raws, descs), refs, names, "PackedEncoder.encode")
    s["packed"] = dict(dec=dec, enc=enc)
    log(f"phase 3: PackedDecoder.decode and PackedEncoder.encode equal the "
        f"oracle on all {len(blobs)} requests")


def phase3_api(s, dev):
    """api's torch backend on API_IMAGES, decode and encode, against its
    native backend."""
    for name in API_IMAGES:
        i = s["names"].index(name)
        blob, raw, d = s["blobs"][i], s["raws"][i], s["descs"][i]
        got = api.decode(blob, backend="torch", device=dev).value()
        want = api.decode(blob, backend="native").value()
        expect(got.desc == want.desc and np.array_equal(got.data, want.data),
               f"api.decode[{name}]: the torch backend differs from native")
        enc = api.encode(raw, d, backend="torch", device=dev).value()
        expect(np.array_equal(enc, api.encode(raw, d,
                                              backend="native").value()),
               f"api.encode[{name}]: the torch backend differs from native")
        log(f"phase 3: api torch backend [{name}, {d.width}x{d.height}x"
            f"{int(d.channels)}]: decode and encode equal the native backend")


def drive(label, fn, needs, totals):
    """Run one path with every launch count at 0, then require each kernel
    of `needs` (or of what `needs()` returns after the run) to have
    launched in it; add the counts to totals.  Returns the run's counts."""
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
    return launches


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


_REPLAYS = {
    "replay": (replay_kernel.replay_batch_carry,
               replay_kernel.replay_batch_carry_reference),
    "replay_summary": (replay_kernel.replay_batch_summary,
                       replay_kernel.replay_batch_summary_reference)}


def _replay_check(name, meta_t, val_t, carry, what, starts=()):
    """K1 ("replay") or K5 ("replay_summary") on the rows its path gives
    it, from ``carry``, against its plain version on PLAIN_REPLAY_ROWS-row
    windows: the first rows (every output), the last rows from the
    kernel's own carry after the rows before them (the emits there, and
    the final state), and the rows from each of ``starts`` on, also from
    the kernel's carry (the emits there).  Returns (the largest
    difference, the kernel's output on all rows, the first rows)."""
    fn, ref = _REPLAYS[name]
    c = meta_t.shape[0]
    n = min(PLAIN_REPLAY_ROWS, c)
    pm, pv = meta_t[:n], val_t[:n]
    err = max(selfcheck.max_abs_err(g, w) for g, w in
              zip(fn(pm, pv, *carry), ref(pm, pv, *carry)))
    expect(err == 0, f"{name} disagrees with its plain version on the "
           f"first {n} rows ({what})")
    full = fn(meta_t, val_t, *carry)
    for s in sorted({min(max(int(s), 0), c - n) for s in starts}
                    | {c - n}):
        mid = fn(meta_t[:s], val_t[:s], *carry)[1:3] if s else carry
        want = ref(meta_t[s:s + n], val_t[s:s + n], *mid)
        errs = [selfcheck.max_abs_err(full[0][s:s + n], want[0])]
        if s == c - n:  # the final state too
            errs += [selfcheck.max_abs_err(full[1], want[1]),
                     selfcheck.max_abs_err(full[2], want[2])]
        expect(max(errs) == 0, f"{name} disagrees with its plain version "
               f"on rows {s}..{s + n} ({what})")
        err = max(err, *errs)
    return err, full, (pm, pv)


def _replay_row(name, meta_t, val_t, carry, launches, card, what,
                starts=()):
    """K1 ("replay") or K5 ("replay_summary") on the rows its path gives it,
    from ``carry``: held against its plain version as _replay_check holds
    it (the first and last PLAIN_REPLAY_ROWS rows and a window at each of
    ``starts``), then timed beside the plain version and the first
    build's time.  The chain bound beside the row's bound: the longest
    chain of dependent operations the function needs on these rows
    (replay_probe.chain_depth) at the dependent-issue latency and the SM
    clock measured just after the timed calls
    (replay_probe.chain_latency); the share is the kernel's time against
    the larger of the two."""
    fn, ref = _REPLAYS[name]
    c, b = meta_t.shape
    err, full, (pm, pv) = _replay_check(name, meta_t, val_t, carry, what,
                                        starts)
    n = pm.shape[0]
    depth = replay_probe.chain_depth(meta_t, full[0])
    del full
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
        name, launches[name], err, ms, plain_ms, nbytes, ops,
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
        f"(kernel on those rows {prefix_ms:.3f} ms); head, tail and "
        f"{len(starts)} more windows equal the plain version, on {card}")
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
    # K3's and K4's arguments as the batch encoder gives them
    with _recorded(*_ENCODE_CALLS) as calls:
        pipe.encode_packed_checked(packed)
    given = {name: (args, kwargs) for name, args, kwargs, _ in calls}
    del calls
    (planes, keep), kw = given["compact_rows"]
    k3, _, _ = _compact_time(planes, keep, kw["cap"], card)
    rows.append(_kernel_row(
        "compact", launches["compact"], k3.pop("err"), k3.pop("ms"),
        k3.pop("plain_ms"), k3.pop("bytes"), k3.pop("ops"), **k3))

    args, _ = given["emit_bytes"]
    off = args[0]
    del given, planes, keep
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
    _tight_caps_time(run, card)
    return rows


def _tight_caps_time(run, card):
    """The batch encoder on the batch RGB corpus at the default caps and at
    selfcheck.tight_caps, where chunk_cap < n_px and encode_rows finds
    each row's chunk_cap-th chunk (nth_chunk) for the rows K3 cut short:
    held against the compact-first chain, both calls and that scan alone
    timed (events); logged only."""
    pipe, packed = run["pipe"], run["packed_in"]
    n_px, ch = pipe.n_px, pipe.channels
    cap, out_cap = selfcheck.tight_caps(packed, n_px)
    expect(cap < n_px, f"tight chunk_cap {cap} not under n_px {n_px}")
    err = selfcheck.batch_encode_err(packed, n_px, ch, cap, out_cap)
    expect(err == 0, "the batch encoder at tight caps differs from the "
           "compact-first chain")
    header = torch.arange(1, 15, dtype=torch.uint8, device=packed.device)
    default_ms, tight_ms = (timed_ms(lambda c=c: enc_ops.encode_batch_checked(
        packed, n_px, header, ch, chunk_cap=c[0], out_cap=c[1]))
        for c in ((None, None), (cap, out_cap)))
    _, keep, _ = selfcheck.chunk_positions(packed, n_px)
    cut = int((keep.sum(dim=1) > cap).sum())
    scan_ms = timed_ms(lambda: enc_ops.nth_chunk(keep, cap))
    log(f"phase 5: batch encode ({packed.shape[0]} x {packed.shape[1]} px) "
        f"at the default caps {default_ms:.3f} ms, at tight caps (chunk_cap "
        f"{cap}, out_cap {out_cap}; {cut} rows cut short) {tight_ms:.3f} ms, "
        f"equal to the compact-first chain; nth_chunk's scan alone "
        f"{scan_ms:.3f} ms, on {card}")


def _compact_time(planes, keep, cap, card):
    """K3 on batch encode's sub-batch rows (E1's two template planes)
    against its plain version on counts and the rows below counts, the
    whole compact_rows call timed (events, and device time by kernel
    group) beside the plain version and the first build; its launch
    configuration logged.  The bound
    counts what the function must move: keep once, each kept row's plane
    values read and written once, counts; the first build's formula (every
    plane row read, cap rows written) is logged beside it."""
    args = (planes, keep, cap)
    got = compact_kernel.compact_rows(*args)
    counts = got[1]
    err = _compact_same(cap)(got, compact_kernel.compact_rows_reference(*args))
    expect(err == 0, "compact disagrees with its plain version")
    call = lambda: compact_kernel.compact_rows(*args)
    ms = timed_ms(call)
    prof = profile.profile_path(call, calls=20, warmup=1)
    expect("K3 compact" in prof["groups"], "the profiler saw no K3 kernel")
    dev_ms = prof["groups"]["K3 compact"][0]
    # the same launch with no row kept: keep read, scans and look-back only
    none_kept = torch.zeros_like(keep)
    empty_ms = device_ms(
        lambda: compact_kernel.compact_rows(planes, none_kept, cap),
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
                 cap=cap), *got)


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
    first = FIRST_BUILD_MS.get(f"place_fill {where}")
    log(f"phase 5: place_fill on the {where} path ({b} x {q} rows -> "
        f"{n_cap} px, {b * n_cap // place_kernel.WIN} windows): "
        f"{ms:.4f} ms (device {dev_ms:.4f}; first build "
        f"{'not timed' if first is None else f'{first} ms'}), "
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


def _scan_time(regions, what, card):
    """The chunk-start scan on regions against its plain version, one
    launch a call, then both timed: event ms, device ms and device ops a
    call (torch.profiler), plain ms, and the bound (each byte read, each
    flag written)."""
    err = selfcheck.chunk_starts_err(regions)
    expect(err == 0, f"chunk_starts disagrees with its plain version on "
           f"{what}")
    before = kernels.LAUNCHES["chunk_starts"]
    boundary.chunk_starts_batch(regions)
    expect(kernels.LAUNCHES["chunk_starts"] == before + 1,
           f"chunk_starts launched other than once a call on {what}")
    ms = timed_ms(lambda: boundary.chunk_starts_batch(regions))
    groups = profile.profile_path(
        lambda: boundary.chunk_starts_batch(regions), calls=20,
        warmup=1)["groups"]
    expect("boundary scan" in groups, "the profiler saw no chunk_starts "
           "kernel")
    plain_ms = timed_ms(
        lambda: boundary.chunk_starts_batch_plain(regions))
    b, qb = regions.shape
    bound_s, bound_by = bound(2 * b * qb, 0)
    out = dict(err=err, ms=ms, device_ms=groups["boundary scan"][0],
               ops_a_call=sum(n for _, n in groups.values()),
               plain_ms=plain_ms, bound_ms=bound_s * 1e3, bytes=2 * b * qb,
               shape=f"{b} x {qb}, row stride {regions.stride(0)}")
    log(f"phase 5: chunk_starts ({what}: {out['shape']}): {ms:.4f} ms, "
        f"device {out['device_ms']:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{out['bound_ms']:.5f} ms ({bound_by}), share "
        f"{out['bound_ms'] / out['device_ms']:.3f}; device ops a call "
        f"{out['ops_a_call']:g} (the kernel and its status words' fill); on "
        f"{card}")
    return out


def phase5_chunk_starts(run, sparse, launches, dev, card):
    """The chunk-start scan at batch1080_decode's shape (SCAN_BATCH rows of
    the batch RGB corpus's regions) and on the streaming decoder's first
    SCAN_WINDOW window of the sparse split stream (the (L, qb + 8) plane's
    view, as _decode_window_lanes reads it); its launch configuration and
    ptxas report logged."""
    pipe = run["pipe"]
    q = torch.arange(pipe.qb, device=dev)[None, :]
    reg = torch.where(q < (run["sizes"] - 14)[:, None],
                      run["streams"][:, 14: 14 + pipe.qb], 0)
    reg = reg.repeat(-(-SCAN_BATCH // reg.shape[0]), 1)[:SCAN_BATCH]
    batch = _scan_time(reg.contiguous(), "batch1080_decode's shape", card)
    dec = device_stream.DeviceStreamDecoder(device=dev)
    blob = sparse["blob"]
    expect(bool(dec.initialize(blob[:14].tobytes())), "the stream decoder "
           "refused the sparse stream's header")
    plane, _, _, qseg, *_ = dec.plan_window(
        blob[14: 14 + SCAN_WINDOW].tobytes())
    window = _scan_time(torch.from_numpy(plane).to(dev)[:, :qseg],
                        "a stream window", card)
    tile = boundary.scan_tile()
    log(f"phase 5: chunk_starts launch: B x ceil(Qb / {tile}) blocks of "
        f"{tile // 16} threads, 16 bytes a thread; ptxas: "
        f"{ptxas_of('chunk_starts_kernel')}")
    batch.pop("bound_ms")  # the row's own, from the bytes
    return _kernel_row(
        "chunk_starts", launches["chunk_starts"],
        max(batch.pop("err"), window.pop("err")), batch.pop("ms"),
        batch.pop("plain_ms"), batch.pop("bytes"), 0, **batch,
        **{f"window_{k}": v for k, v in window.items() if k != "bytes"})


def phase5_gather(s, launches, card):
    """G1 on ServingCodec decode of the committed corpus, its files once
    (one serving_corpus_decode call holds them on average): the decode
    against the oracle, each engine part's G1 call held against the plain
    version over its whole output from a sentinel, one launch a call;
    then the call's G1 launches together timed (event ms, device ms by
    profiler group, the bound: each word read and each output byte
    written, 4 + channels bytes a pixel) beside the plain version."""
    codec, k = s["codec"], CORPUS_STREAMS
    with _recorded((gather_kernel, ("gather_pixels",))) as calls:
        got = codec.decode(s["blobs"][:k])
    _check_all(got, s["raws"][:k], s["names"][:k],
               "serving decode of the corpus once")
    parts = [(args[0], args[1], args[3]) for _, args, _, _ in calls]
    nbytes = calls[0][1][2].numel()
    err = 0
    for src, table, _ in parts:
        before = kernels.LAUNCHES["gather_pixels"]
        err = max(err, selfcheck.gather_err(src, table, nbytes))
        expect(kernels.LAUNCHES["gather_pixels"] == before + 1,
               "gather_pixels launched other than once a part")
    expect(err == 0, "gather_pixels disagrees with its plain version on "
           "the serving corpus")
    out = torch.empty(nbytes, dtype=torch.uint8, device=codec.device)

    def call():
        for src, table, table_dev in parts:
            gather_kernel.gather_pixels(src, table, out, table_dev)

    def plain():
        for src, table, _ in parts:
            gather_kernel.gather_pixels_plain(src, table, out)

    ms = timed_ms(call)
    groups = profile.profile_path(call, calls=20, warmup=1)["groups"]
    expect("G1 gather" in groups, "the profiler saw no gather_pixels kernel")
    plain_ms = timed_ms(plain, warmup=1, runs=3)
    rows = np.concatenate([t for _, t, _ in parts])
    px = int(rows[:, 1].sum())
    moved = int((rows[:, 1] * (4 + rows[:, 3])).sum())
    bound_s, bound_by = bound(moved, 0)
    device = groups["G1 gather"][0]
    what = (f"{len(parts)} parts, {len(rows)} segments, {px} px, "
            f"{nbytes} bytes out")
    log(f"phase 5: gather_pixels (serving decode of the corpus once: "
        f"{what}): {ms:.4f} ms, device {device:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_s * 1e3:.5f} ms ({bound_by}), "
        f"share {bound_s * 1e3 / device:.3f}; launch: a block of 256 "
        f"threads a {gather_kernel.TILE_PX}-pixel tile; ptxas: "
        f"{ptxas_of('gather_pixels_kernel')}; on {card}")
    return _kernel_row("gather_pixels", launches["gather_pixels"], err, ms,
                       plain_ms, moved, 0, device_ms=device, shape=what)


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
    windows = b * n_cap // place_kernel.WIN
    blocks = windows // 2 if name == "place_fill2" else windows
    entry = {"place_wide": f"place_wide_kernelILi{lanes}E",
             "place_fill2": "place_fill2_kernel",
             "place_fill_narrow": "place_narrow_kernel",
             "place_variant": "place_variant_kernelILb1ELb1ELi6E"}[name]
    extra = _beside_k2(name, call, k2, "E2/E3/E5/E6 windowed placement",
                       blocks, entry, card)
    if name == "place_wide":
        extra.update(launch=_launch(blocks, place_window.launch_shape(name)),
                     ptxas=ptxas_of(entry))
        log(f"phase 5: {name}: device {extra['device_ms']:.4f} ms, first "
            f"build device {FIRST_BUILD_MS[name]} ms on {card}")
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


def _launch(blocks, shape):
    """A launch configuration as text: blocks, (threads, resident blocks
    an SM)."""
    threads, per_sm = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"{blocks} blocks of {threads} threads, {per_sm} resident an "
            f"SM on {sms} SMs ({blocks / (per_sm * sms):.1f} waves)")


def _beside_k2(name, call, k2, group, blocks, entry, card):
    """E2-E6's device time (profiler group ``group``) and K2's on the
    same input, returned as kernel row fields; logged with the kernel's
    launch configuration and ptxas report (its kernel entries whose names
    hold ``entry``), which stay out of the row."""
    dev_ms = device_ms(call, group)
    k2_dev_ms = device_ms(k2, "K2 place_fill")
    launch = _launch(blocks, place_window.launch_shape(name))
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


def _emit_inputs(dev, fill):
    """E7's script input at 8 x 2^17 rows and ``fill``: (off, tlo, thn,
    out_cap, base at 256 lanes)."""
    off_np, tlo_np, thn_np, out_cap = expt_emit_wide.gen_inputs(
        np.random.default_rng(0), 8, 1 << 17, fill=fill)
    off = torch.from_numpy(off_np).to(dev)
    tlo, thn = (torch.from_numpy(x.view(np.int32)).to(dev)
                for x in (tlo_np, thn_np))
    return (off, tlo, thn, out_cap,
            emit_window.window_base_rows_w(off, out_cap, 256))


def emit_needs(off, out_cap):
    """(bytes E7 must move, bytes of every row) on off (B, C): 12 read a
    row before each image's trailing run of equal offs and for the run's
    last row (only the last row of a run writes), 4 written an output
    byte; and 12 a row of every row with the same output."""
    o = off.cpu().numpy()
    b, c = o.shape
    needed = sum(c - int((r == r[-1]).sum()) + 1 for r in o)
    out = 4 * b * out_cap
    return 12 * needed + out, 12 * b * c + out


def phase5_emit_window(results, launches, dev, card):
    """E7 at its wrapper's defaults (256 lanes) on its script's input
    against the plain version, timed (event and device) beside K4 and the
    plain version, base rows outside the timed call; and at fill 0.999,
    where the trailing run of equal offs is ~130 rows, not ~32,770.
    bound: what it must move (emit_needs), the bound of every row
    logged."""
    off, tlo, thn, out_cap, base = _emit_inputs(dev, 0.75)
    call = lambda: emit_window.emit_wide(off, tlo, thn, base, out_cap)
    plain = lambda: emit_window.emit_wide_reference(off, tlo, thn, out_cap)
    err = selfcheck.max_abs_err(call(), plain())
    expect(err == 0, "emit_window disagrees with its plain version")
    plain_ms = timed_ms(plain)
    ms = timed_ms(call)
    k4 = lambda: emit_kernel.emit_bytes(off, tlo, thn, out_cap)
    k4_ms = timed_ms(k4)
    dev_ms = device_ms(call, "E7 emit_wide")
    k4_dev_ms = device_ms(k4, "K4 emit")
    b, c = off.shape
    needs, every_row = emit_needs(off, out_cap)
    full = _emit_inputs(dev, 0.999)
    full_call = lambda: emit_window.emit_wide(*full[:3], full[4], full[3])
    err = max(err, selfcheck.max_abs_err(
        full_call(), emit_window.emit_wide_reference(*full[:4])))
    expect(err == 0, "emit_window disagrees with its plain version at "
           "fill 0.999")
    full_ms, full_dev_ms = timed_ms(full_call), device_ms(
        full_call, "E7 emit_wide")
    launch = _launch(b * out_cap // emit_window.WIN,
                     emit_window.launch_shape(256))
    entry = "emit_window_kernelILi256E"
    log(f"phase 5: emit_window (8 x {c} rows -> {out_cap} bytes): "
        f"{ms:.4f} ms, device {dev_ms:.4f} ms (first build device "
        f"{FIRST_BUILD_MS['emit_window']}), K4 {k4_ms:.4f} ms, K4 device "
        f"{k4_dev_ms:.4f} ms, plain {plain_ms:.4f} ms; at fill 0.999 "
        f"({full[0].shape[1]} rows -> {full[3]} bytes) {full_ms:.4f} ms, "
        f"device {full_dev_ms:.4f} ms ({dev_ms / full_dev_ms:.3f}x); bound "
        f"{bound(needs, 0)[0] * 1e3:.5f} ms ({needs} bytes it must move), "
        f"{bound(every_row, 0)[0] * 1e3:.5f} ms ({every_row} bytes with "
        f"every row); launch: {launch}; ptxas: {ptxas_of(entry)}; on "
        f"{card}")
    rows = results["emit_window"]
    return _kernel_row(
        "emit_window", launches["emit_window"], _worst(err, rows), ms,
        plain_ms, needs, OPS_PER_ELEMENT["emit"] * b * out_cap, rows=c,
        images=b, out_cap=out_cap, device_ms=dev_ms, k4_ms=k4_ms,
        k4_device_ms=k4_dev_ms, ms_fill999=full_ms,
        device_ms_fill999=full_dev_ms, launch=launch, ptxas=ptxas_of(entry),
        variants=_variants(rows))


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


def _same_whole(got, want):
    """The largest difference over every output of two calls."""
    return max(selfcheck.max_abs_err(g, w) for g, w in zip(
        got if isinstance(got, tuple) else (got,),
        want if isinstance(want, tuple) else (want,)))


def _compact_same(cap):
    """K3's results compared as their readers read them: counts, and each
    plane's rows below its lane's count."""
    def same(got, want):
        (planes, counts), (rplanes, rcounts) = got, want
        live = torch.arange(cap, device=counts.device)[None, :] < \
            counts[:, None]
        return max(selfcheck.max_abs_err(counts, rcounts), *(
            selfcheck.max_abs_err(torch.where(live, g, 0),
                                  torch.where(live, w, 0))
            for g, w in zip(planes, rplanes)))
    return same


def _hold(held, name, err, what):
    """Record one held shape of a kernel; fail where it differs."""
    expect(err == 0, f"{name} disagrees with its plain version on {what}")
    held.setdefault(name, []).append(dict(what=what, max_abs_err=err))


def _hold_call(held, name, call, plain, what, same=_same_whole):
    """A kernel's wrapper against its plain version on one input of its
    path; returns the wrapper's result, which the path reads next."""
    got = call()
    _hold(held, name, same(got, plain()), what)
    return got


def _timed(name, call, plain, what, card, nbytes, ops):
    """A held kernel call timed beside its plain version; the fields kept
    under the kernel's row's "serving"."""
    ms, plain_ms = timed_ms(call), timed_ms(plain, warmup=1, runs=3)
    bound_s, bound_by = bound(nbytes, ops)
    log(f"phase 5: {name} on {what}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_s * 1e3:.5f} ms ({bound_by}), equal to the plain "
        f"version, on {card}")
    return dict(what=what, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by)


def _reset_window(seg_flat, qb):
    """The first row of a PLAIN_REPLAY_ROWS window that holds the first
    stream reset inside a packed lane (a stream start past its lane's
    first row), and the resets inside that window; (None, 0) where every
    lane holds one stream."""
    rows = seg_flat.cpu().numpy() % qb
    inner = rows[rows > 0]
    if not inner.size:
        return None, 0
    start = max(int(inner.min()) - 16, 0)
    return start, int(((inner >= start)
                       & (inner < start + PLAIN_REPLAY_ROWS)).sum())


def _hold_packed_decode(held, staged, what):
    """K1 and K2 on a packed decode plan as dispatch_staged runs them: K1
    on its first and last rows and on a window over the first stream reset
    inside a lane (meta bit 9), K2 on its whole output."""
    regions, seg, chunks, _, _, qb, n_cap, l_total = staged
    meta_t, val_t, pix_before = packed_lanes.lane_inputs(
        regions, seg, chunks, qb, l_total)
    start, resets = _reset_window(seg, qb)
    err, full, _ = _replay_check(
        "replay", meta_t, val_t,
        replay_kernel.initial_state(l_total, meta_t.device), what,
        () if start is None else (start,))
    _hold(held, "replay", err, f"{what} ({qb} x {l_total} rows; first, "
          f"last" + ("; no lane holds two streams)" if start is None else
                     f" and rows {start}.., {resets} resets inside lanes "
                     f"there)"))
    emits = full[0].T.contiguous()
    del full
    _hold_call(held, "place_fill",
               lambda: place_kernel.place_fill(pix_before, emits, n_cap),
               lambda: place_kernel.place_fill_reference(pix_before, emits,
                                                         n_cap),
               f"{what} ({l_total} x {qb} rows -> {n_cap} px)")
    return resets


def _hold_split(held, staged, what):
    """K3 (where the plan takes the chunk domain), K5 at every fixpoint
    round's in-state (its first and last rows) and K2 on a split decode
    plan, as dispatch_staged runs them."""
    (regions, heads, chunks_sizes, px_budgets, max_chain, _, _, qb, n_cap,
     qc) = staged
    lanes = regions.shape[0]
    if qc:
        meta, val, pb, real = split.lane_fields(regions, chunks_sizes,
                                                px_budgets, qb)
        args = ((meta, val, pb), real, qc)
        _hold_call(held, "compact",
                   lambda: compact_kernel.compact_rows(*args),
                   lambda: compact_kernel.compact_rows_reference(*args),
                   f"{what}, 3 planes ({lanes} x {qb} -> {qc})",
                   _compact_same(qc))
        del meta, val, pb, real
    meta_t, val_t, pix_before = split.lane_rows(regions, chunks_sizes,
                                                px_budgets, qb, n_cap, qc)
    # seam_fixpoint's rounds, each round's in-state held
    in_p, in_s = split.initial_guess(lanes, meta_t.device)
    rounds = 0
    while True:
        err, full, _ = _replay_check("replay_summary", meta_t, val_t,
                                     (in_p, in_s), f"{what}, round {rounds}")
        _hold(held, "replay_summary", err,
              f"{what}, round {rounds} ({meta_t.shape[0]} x {lanes} rows)")
        want_p, want_s, _ = dec_ops.propagate(heads, *full[1:])
        rounds += 1
        if bool((want_p == in_p).all() & (want_s == in_s).all()) or \
                rounds >= max_chain + 2:
            break
        in_p, in_s = want_p, want_s
    emits = full[0].T.contiguous()
    del full
    _hold_call(held, "place_fill",
               lambda: place_kernel.place_fill(pix_before, emits, n_cap),
               lambda: place_kernel.place_fill_reference(pix_before, emits,
                                                         n_cap),
               f"{what} ({lanes} x {pix_before.shape[1]} rows -> {n_cap} "
               f"px)")
    return rounds


def _lane_encode_inputs(held, staged, what):
    """The packed-lane encoder (ops/encode._encode_lanes_impl) on a
    PackedEncoder plan, its K3 calls held as they run: returns the two
    compactions' and K4's arguments and a label of each."""
    pk_d, flags_d, _, caps, _ = staged
    chunk_cap, out_cap, ends_cap = enc_ops.lane_caps(
        pk_d.shape[1], caps["chunk_cap"], caps["out_cap"], caps["ends_cap"])
    aug, posflag, keep, bits = enc_ops.lane_positions(pk_d, flags_d)
    args = ((aug, posflag), keep, chunk_cap)
    l, n = keep.shape
    two = f"{what}, 2 planes ({l} x {n} -> {chunk_cap})"
    (pk_c, pf_c), counts = _hold_call(
        held, "compact", lambda: compact_kernel.compact_rows(*args),
        lambda: compact_kernel.compact_rows_reference(*args), two,
        _compact_same(chunk_cap))
    off, tlo, thn, incl, t1, _ = enc_ops.lane_templates(pk_c, pf_c, counts,
                                                        bits)
    eargs = ((incl,), t1, ends_cap)
    one = (f"{what}, 1 plane ({l} x {chunk_cap} -> {ends_cap}, "
           f"{int(t1.sum())} stream ends)")
    _hold_call(held, "compact", lambda: compact_kernel.compact_rows(*eargs),
               lambda: compact_kernel.compact_rows_reference(*eargs), one,
               _compact_same(ends_cap))
    k4 = (off, tlo, thn, out_cap)
    emit = f"{what} ({l} x {off.shape[1]} rows -> {out_cap} bytes)"
    _hold_call(held, "emit", lambda: emit_kernel.emit_bytes(*k4),
               lambda: emit_kernel.emit_bytes_reference(*k4), emit)
    return (args, two, int(counts.sum())), (eargs, one), (k4, emit)


def _hold_batch_encode(held, packed, n_px, channels, chunk_cap, out_cap,
                       what):
    """E1, K3 and K4 on the batch encoder's input (ops/encode.encode_rows)
    as they run on it, recorded in one encode_batch_checked call."""
    header = torch.arange(1, 15, dtype=torch.uint8, device=packed.device)
    with _recorded(*_ENCODE_CALLS) as calls:
        enc_ops.encode_batch_checked(packed, n_px, header, channels,
                                     chunk_cap=chunk_cap, out_cap=out_cap)
    _hold_recorded(held, calls, f"{what} ({packed.shape[0]} x "
                   f"{packed.shape[1]} px)")


def _hold_api(held, blob, raw, d, dev, what):
    """api's torch backend on one image: K1 on the one-shot decode's lane
    (its first and last rows), K6 on its flagged words where every emit
    is opaque (the engine ops/decode.expand_bytes_batch takes), and E1, K3
    and K4 on the one-shot encode's B=1 input."""
    meta, val, real, produced, pix_before, n_cap = \
        dec_ops.single_lane_inputs(blob, d, dev)
    err, full, _ = _replay_check("replay", meta, val,
                                 replay_kernel.initial_state(1, dev), what)
    _hold(held, "replay", err, f"{what} decode ({meta.shape[0]} x 1 rows)")
    emits = full[0].reshape(1, -1)
    del full
    if bool((((emits >> 24) & 0xFF) == 0xFF).all()):
        words = dec_ops.flagged_words(emits, real, produced, pix_before,
                                      n_cap)
        _hold_call(held, "logfill",
                   lambda: replay_kernel.logfill_batch(words),
                   lambda: replay_kernel.logfill_batch_reference(words),
                   f"{what} decode ({n_cap} words)")
    packed, _ = backend.encode_inputs(raw, d, dev)
    _hold_batch_encode(held, packed, d.width * d.height, int(d.channels),
                       None, None, f"{what} encode")


def phase5_serving_kernels(s, rows, launches, card):
    """Every kernel of the serving path, the packed lanes and the api
    torch backend against its plain version at each shape those paths
    give it, on the inputs they give it: K1 and K2 on every packed decode
    tier and on PackedDecoder's own plan (K1 also on a window over the
    first stream reset inside a lane), K3, K5 at every fixpoint round and
    K2 on every split group, K3's two compactions and K4 on every packed
    encode tier and on PackedEncoder's own lanes, E1, K3 and K4 on every
    geometry bucket, and K1, K6, E1, K3 and K4 on api's images; kept in each
    kernel's row under "held_at".  K1 and K2 on the first decode tier and
    K3 and K4 on the first encode tier are also timed beside their plain
    versions (the row's "serving")."""
    codec, blobs, raws, descs = (s[k] for k in ("codec", "blobs", "raws",
                                                "descs"))
    dev = codec.device
    by_name = {r["name"]: r for r in rows}
    held = {}
    _, dec_tiers, split_groups = codec.decode_stage(blobs)
    resets = [_hold_packed_decode(held, staged, f"serving packed decode "
                                  f"tier {t} ({len(idxs)} streams)")
              for t, (idxs, staged) in enumerate(dec_tiers)]
    for g, (grp, staged) in enumerate(split_groups):
        _hold_split(held, staged, f"serving split group {g} ({len(grp)} "
                    f"streams)")
    resets.append(_hold_packed_decode(
        held, s["packed"]["dec"].stage_to_device(blobs),
        f"PackedDecoder ({len(blobs)} streams)"))
    expect(resets[0] and resets[-1], "no reset inside a lane was held on "
           "the first decode tier or PackedDecoder's plan")
    _, enc_tiers, buckets = codec.encode_stage(raws, descs)
    enc0 = None  # the first tier's inputs, timed below
    for t, (tier, staged) in enumerate(enc_tiers):
        got = _lane_encode_inputs(held, staged, f"serving packed encode "
                                  f"tier {t} ({len(tier)} streams)")
        enc0 = enc0 or got
    for idxs, pipe, batch_d, d in buckets:
        _hold_batch_encode(
            held, pipe.raw_to_packed(batch_d), pipe.n_px, pipe.channels,
            pipe.chunk_cap, pipe.out_cap,
            f"serving bucket {d.width}x{d.height}x{int(d.channels)} "
            f"({len(idxs)} of {batch_d.shape[0]} lanes)")
    _lane_encode_inputs(held, s["packed"]["enc"].stage_to_device(raws,
                                                                 descs),
                        f"PackedEncoder ({len(raws)} streams)")
    for name in API_IMAGES:
        i = s["names"].index(name)
        _hold_api(held, s["blobs"][i], s["raws"][i], s["descs"][i], dev,
                  f"api [{name}]")
    for name in ("replay", "place_fill", "replay_summary", "fields",
                 "compact", "emit", "logfill"):
        expect(name in held, f"phase 5 held {name} at no serving shape")

    # timed: K1 and K2 on the first decode tier, K3 and K4 on the first
    # encode tier
    regions, seg, chunks, _, _, qb, n_cap, l_total = dec_tiers[0][1]
    meta_t, val_t, pix_before = packed_lanes.lane_inputs(
        regions, seg, chunks, qb, l_total)
    start, _ = _reset_window(seg, qb)  # held above, so not None
    k1 = _replay_row("replay", meta_t, val_t, replay_kernel.initial_state(
        l_total, meta_t.device), launches, card,
        f"serving packed decode tier of {len(dec_tiers[0][0])} streams",
        (start,))
    by_name["replay"]["serving"] = {
        k: k1[k] for k in ("rows", "lanes", "max_abs_err", "ms", "plain_ms",
                           "plain_rows", "ms_on_plain_rows", "bound_ms",
                           "ns_per_row", "state_rows", "ns_per_state_row")}
    emits = replay_kernel.replay_batch(meta_t, val_t).T.contiguous()
    k2 = _place_fill_time(pix_before, emits, n_cap, "serving packed", card)
    by_name["place_fill"]["serving"] = {
        k: k2[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "rows",
                           "images", "n_cap")}
    del meta_t, val_t, pix_before, emits

    (args, two, kept), (eargs, one), (k4, emit) = enc0
    (_, keep, cap), (_, t1, ends_cap) = args, eargs
    l, n = keep.shape
    nseg = int(t1.sum())
    by_name["compact"]["serving"] = dict(
        two_planes=_timed(
            "compact", lambda: compact_kernel.compact_rows(*args),
            lambda: compact_kernel.compact_rows_reference(*args),
            f"{two}, {kept} kept", card, l * n + 16 * kept + 4 * l,
            OPS_PER_ELEMENT["compact"] * l * n),
        one_plane=_timed(
            "compact", lambda: compact_kernel.compact_rows(*eargs),
            lambda: compact_kernel.compact_rows_reference(*eargs), one,
            card, l * cap + 8 * nseg + 4 * l,
            OPS_PER_ELEMENT["compact"] * l * cap))
    by_name["emit"]["serving"] = _timed(
        "emit", lambda: emit_kernel.emit_bytes(*k4),
        lambda: emit_kernel.emit_bytes_reference(*k4), emit, card,
        12 * k4[0].numel() + l * k4[3], OPS_PER_ELEMENT["emit"] * l * k4[3])
    for name, shapes in held.items():
        row = by_name[name]
        row["held_at"] = shapes
        row["max_abs_err"] = max(row["max_abs_err"],
                                 *(h["max_abs_err"] for h in shapes))
    log(f"phase 5: held against their plain versions at the serving, "
        f"packed and api paths' shapes: "
        f"{ {k: len(v) for k, v in held.items()} }")


def _sync_after(fn):
    """fn, then a wait for the device: a path's time to completion."""
    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def phase5_serving_times(s, card):
    """The serving path's times on the serving corpus, MPix/s: decode to
    completion (plan, upload, kernels), pre-staged, from the resident
    corpus, overlapped, end to end with the fetch; encode to completion,
    pre-staged, end to end."""
    codec, blobs, raws, descs, mpix = (
        s[k] for k in ("codec", "blobs", "raws", "descs", "mpix"))
    what = f"serving[{len(blobs)} requests]"
    _time_path(f"{what} decode_dispatch to completion",
               _sync_after(lambda: codec.decode_dispatch(blobs)), mpix, card)
    staged = codec.decode_stage(blobs)
    torch.cuda.synchronize()
    _time_path(f"{what} decode_dispatch_staged (pre-staged)",
               lambda: codec.decode_dispatch_staged(staged), mpix, card)
    _time_path(f"{what} resident decode_device", s["resident"].decode_device,
               mpix, card)
    _time_path(f"{what} decode_dispatch_overlapped to completion",
               _sync_after(lambda: codec.decode_dispatch_overlapped(blobs)),
               mpix, card)
    _time_path(f"{what} decode end to end (with the fetch)",
               lambda: codec.decode(blobs), mpix, card)
    _time_path(f"{what} encode_dispatch to completion",
               _sync_after(lambda: codec.encode_dispatch(raws, descs)), mpix,
               card)
    estaged = codec.encode_stage(raws, descs)
    torch.cuda.synchronize()
    _time_path(f"{what} encode_dispatch_staged (pre-staged)",
               lambda: codec.encode_dispatch_staged(estaged), mpix, card)
    _time_path(f"{what} encode end to end (with the fetch)",
               lambda: codec.encode(raws, descs), mpix, card)


def phase5_packed_times(s, card):
    """PackedDecoder and PackedEncoder alone on the serving corpus:
    decode to completion and end to end, encode to completion, pre-staged
    and end to end; then, by the host clock, the planners and the serving
    path's fetch (decode_finish after a resident decode, encode_finish
    after a pre-staged encode, each with its device work)."""
    dec, enc = s["packed"]["dec"], s["packed"]["enc"]
    blobs, raws, descs, mpix = (s[k] for k in ("blobs", "raws", "descs",
                                               "mpix"))
    estaged = s["codec"].encode_stage(raws, descs)
    what = f"packed[{len(blobs)} streams]"
    _time_path(f"{what} PackedDecoder.decode_to_device to completion",
               _sync_after(lambda: dec.decode_to_device(blobs)), mpix, card)
    _time_path(f"{what} PackedDecoder.decode end to end",
               lambda: dec.decode(blobs), mpix, card)
    _time_path(f"{what} PackedEncoder stage and dispatch to completion",
               _sync_after(lambda: enc.dispatch_staged(
                   enc.stage_to_device(raws, descs))), mpix, card)
    staged = enc.stage_to_device(raws, descs)
    torch.cuda.synchronize()
    _time_path(f"{what} PackedEncoder.dispatch_staged (pre-staged)",
               lambda: enc.dispatch_staged(staged), mpix, card)
    _time_path(f"{what} PackedEncoder.encode end to end",
               lambda: enc.encode(raws, descs), mpix, card)
    # the host's share: planning (numpy), and the fetch with the cutting
    # and unpacking of every stream, by the host clock (3 calls, the last
    # two's mean)
    for label, fn in (
            ("PackedDecoder.plan_and_pack", lambda: dec.plan_and_pack(blobs)),
            ("PackedEncoder.plan_and_pack",
             lambda: enc.plan_and_pack(raws, descs)),
            ("serving resident decode_device + decode_finish (fetch, cut, "
             "unpack)",
             lambda: s["codec"].decode_finish(s["resident"].decode_device())),
            ("serving encode_dispatch_staged + encode_finish (fetch, cut)",
             lambda: s["codec"].encode_finish(
                 s["codec"].encode_dispatch_staged(estaged)))):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"phase 5: host clock, {what} {label}: {np.mean(ms[1:]):.2f} ms "
            f"(calls {', '.join(f'{m:.2f}' for m in ms)}) on {card}")


# --------------------------------------------------------------------------
# The parallel phase: jobs of local ranks that share the card
# --------------------------------------------------------------------------


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counted(dev, fn):
    """fn's result and the launches it made: every count at 0 just before
    the call, read just after it."""
    _sync(dev)
    kernels.reset_launch_counts()
    out = fn()
    _sync(dev)
    return out, {k: v for k, v in kernels.launch_counts().items() if v}


def _rank_ms(fn, dev, warmup=3, runs=5):
    """(ms a call, the first call's ms) of fn run on every rank at once, by
    the host clock between barriers: the slowest rank sets it."""
    def span(n):
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(dev)
        dist.barrier()
        return (time.perf_counter() - t0) * 1e3 / n
    first = span(1)
    for _ in range(warmup):
        fn()
    return span(runs), first


@contextlib.contextmanager
def _recorded(*targets):
    """Record (name, args, kwargs, result) of every call of module.<name>,
    for each (module, names) of ``targets``, made inside the block, in
    order.  The result is a copy: the path may write into what it got
    (the batch encoder writes the header into K4's output)."""
    calls, saved = [], []

    def copy(x):
        return (x.clone() if isinstance(x, torch.Tensor) else
                type(x)(map(copy, x)) if isinstance(x, (tuple, list)) else x)

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((name, args, kwargs, copy(out)))
            return out
        return call

    for module, names in targets:
        for n in names:
            saved.append((module, n, getattr(module, n)))
            setattr(module, n, recorder(n, saved[-1][2]))
    try:
        yield calls
    finally:
        for module, n, fn in saved:
            setattr(module, n, fn)


def _fields_plain(packed, n_px, channels, *carries):
    """E1's plain version, its carries the wrapper's default where the
    caller gives none (the batch encoder's encode_rows)."""
    return fields_kernel.encode_fields_planes_reference(
        packed, n_px, channels,
        *(carries or fields_kernel.start_state(packed.shape[0],
                                               packed.device)))


# the wrappers the parallel and tools paths call, by the name their caller
# looks up: the kernel's name and its plain version (None: K1 and K5, held
# by _replay_check)
_RECORDED = {
    "replay_batch_carry": ("replay", None),
    "replay_batch_summary": ("replay_summary", None),
    "logfill_batch": ("logfill", replay_kernel.logfill_batch_reference),
    "place_fill": ("place_fill", place_kernel.place_fill_reference),
    "encode_fields_planes": ("fields", _fields_plain),
    "compact_rows": ("compact", compact_kernel.compact_rows_reference),
    "emit_bytes": ("emit", emit_kernel.emit_bytes_reference),
    "chunk_starts_batch": ("chunk_starts",
                           boundary.chunk_starts_batch_plain),
    # G1 writes into the output it is given, which the copy the plain
    # version writes into already holds: the bytes inside the segments
    # are held (phase 5 holds the whole output from a sentinel)
    "gather_pixels": ("gather_pixels",
                      lambda src, table, out, table_dev=None:
                      gather_kernel.gather_pixels_plain(src, table, out))}
# where every encoder but the lanes' (ops/encode.encode_rows: the batch
# encoder, the stream windows, sp encode; it imports E1 from its module
# when called) looks up E1, K3 and K4; where dp decode (BatchPipeline; the
# boundary pass finds the chunk-start scan in its own module) looks up
# the decode kernels
_ENCODE_CALLS = ((fields_kernel, ("encode_fields_planes",)),
                 (enc_ops, ("compact_rows", "emit_bytes")))
_DP_CALLS = ((boundary, ("chunk_starts_batch",)),
             (replay_kernel, ("replay_batch_carry",)),
             (place_kernel, ("place_fill",))) + _ENCODE_CALLS
# where the tools and examples reach them: the one-shot codec
# (ops/decode, ops/encode), BatchPipeline, SplitDecoder and the split
# windows (models/split), the device stream codecs and ServingCodec; the
# chunk-start scan in ops/boundary, where every decode path finds it; G1
# in ops/gather_kernel, where the packed and split decoders' one unpack
# (models/packed.gather_streams) finds it
_TOOLS_CALLS = ((boundary, ("chunk_starts_batch",)),
                (replay_kernel, ("replay_batch_carry", "replay_batch_summary",
                                 "logfill_batch")),
                (place_kernel, ("place_fill",)),
                (compact_kernel, ("compact_rows",)),
                (gather_kernel, ("gather_pixels",))) + _ENCODE_CALLS


def _shapes(args, kwargs=None):
    """A call's arguments as tensor shapes and numbers: ((1x8, 1x8), 1x8,
    cap=128)."""
    def one(a):
        return ("x".join(map(str, a.shape)) if isinstance(a, torch.Tensor)
                else _shapes(a) if isinstance(a, (tuple, list)) else str(a))
    return "(" + ", ".join([one(a) for a in args] + [
        f"{k}={one(v)}" for k, v in (kwargs or {}).items()]) + ")"


def _copy_strided(x):
    """A copy of a call's argument or result with its shape and strides (a
    view of a larger buffer copied alone)."""
    if isinstance(x, (tuple, list)):
        return type(x)(map(_copy_strided, x))
    if isinstance(x, dict):
        return {k: _copy_strided(v) for k, v in x.items()}
    if not isinstance(x, torch.Tensor):
        return x
    if 0 in x.stride():
        return x.clone()
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device).copy_(x)


def _elements(x):
    """The tensor elements in a call's arguments."""
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, dict):
        return sum(map(_elements, x.values()))
    if isinstance(x, (tuple, list)):
        return sum(map(_elements, x))
    return 0


@contextlib.contextmanager
def _sampled(targets, every=("logfill",)):
    """A bounded sample of the calls made inside the block to the wrappers
    of ``targets`` (as _recorded takes them) that launched their kernel:
    per kernel the first, the one with the most argument elements, the
    first of the last run of calls at one shape (a timed loop repeats its
    shape: those repeats are neither copied nor kept), and every call of
    a kernel in ``every``; each with copies of its arguments and result
    (not K1's and K5's: _replay_check replays them).  Yields (kept,
    launched): {kernel: {call number: (tags, (name, args, kwargs,
    result))}} and {kernel: calls that launched}."""
    kept, launched, saved = {}, {}, []
    last_shape, largest = {}, {}

    def recorder(name, fn):
        kernel, plain = _RECORDED[name]

        def call(*args, **kwargs):
            before = kernels.LAUNCHES[kernel]
            out = fn(*args, **kwargs)
            if kernels.LAUNCHES[kernel] == before:
                return out
            i = launched[kernel] = launched.get(kernel, 0) + 1
            shape, size = _shapes(args, kwargs), _elements((args, kwargs))
            tags = [t for t, due in (
                ("first", i == 1),
                ("largest", size > largest.get(kernel, -1)),
                ("last shape", shape != last_shape.get(kernel)),
                ("every", kernel in every)) if due]
            last_shape[kernel] = shape
            if not tags:
                return out
            if "largest" in tags:
                largest[kernel] = size
            k = kept.setdefault(kernel, {})
            for j, (t, c) in list(k.items()):  # the tags this call takes
                t = [x for x in t if x not in tags or x == "every"]
                if t:
                    k[j] = (t, c)
                else:
                    del k[j]
            k[i] = (tags, (name, _copy_strided(args), _copy_strided(kwargs),
                           None if plain is None else _copy_strided(out)))
            return out
        return call

    for module, names in targets:
        for n in names:
            saved.append((module, n, getattr(module, n)))
            setattr(module, n, recorder(n, saved[-1][2]))
    try:
        yield kept, launched
    finally:
        for module, n, fn in saved:
            setattr(module, n, fn)


def _hold_recorded(held, calls, what):
    """Each recorded kernel call's result on the path against its plain
    version on the same arguments (K1 as _replay_check holds it: its first
    and last rows, the last from the kernel's own carry)."""
    for name, args, kwargs, out in calls:
        kernel, plain = _RECORDED[name]
        at = f"{what}: {name}{_shapes(args, kwargs)}"
        if plain is None:
            err, _, _ = _replay_check(kernel, args[0], args[1], args[2:], at)
            _hold(held, kernel, err, f"{at}; first and last "
                  f"{PLAIN_REPLAY_ROWS} rows")
            continue
        same = _same_whole
        if kernel == "compact":
            same = _compact_same(kwargs["cap"] if "cap" in kwargs
                                 else args[2])
        _hold(held, kernel, same(out, plain(*args, **kwargs)), at)


def parallel_dp_rank(cfg, path):
    """One rank of the dp job: its block of the batch RGB corpus (saved at
    path) through make_dp_decode, the decoded pixels re-encoded through
    make_dp_encode, each image against the oracle; K1, K2, E1, K3 and K4 held
    against their plain versions on the arguments the path gave them;
    then both timed."""
    dev = launch.rank_device(cfg["device_type"])
    rank = dist.get_rank()
    m = mesh_mod.make_mesh(device_type=cfg["device_type"])
    inp = np.load(path)
    desc = Desc(cfg["w"], cfg["h"], Channels.RGB)
    max_len = int(inp["sizes"].max())
    pipe = BatchPipeline(desc, max_stream_len=max_len,
                         max_encode_len=max_len + 4096, device=dev)
    streams, sizes = (mesh_mod.local_rows(torch.from_numpy(inp[k]).to(dev), m)
                      for k in ("streams", "sizes"))
    first = mesh_mod.axis_index(m, "data") * streams.shape[0]
    blobs = [inp["streams"][first + i, : inp["sizes"][first + i]]
             for i in range(streams.shape[0])]
    dec = sharded.make_dp_decode(pipe, m)
    enc = sharded.make_dp_encode(pipe, m)

    def pad(packed):
        return torch.nn.functional.pad(packed[:, : pipe.n_px],
                                       (0, pipe.nb - pipe.n_px))

    def both():
        packed, checksum = dec(streams, sizes)
        return (packed, checksum) + enc(pad(packed))

    with _recorded(*_DP_CALLS) as calls:
        (packed, checksum, out, lengths), launches = _counted(dev, both)
    for i, blob in enumerate(blobs):
        want = pixels_to_packed(torch.from_numpy(oracle.decode(
            blob, desc, desc.channels)).to(dev), 3)
        expect(bool((packed[i, : pipe.n_px] == want).all()),
               f"rank {rank}: dp decode of image {first + i} differs from "
               "the oracle")
        expect(int(lengths[i]) == blob.size and np.array_equal(
            out[i, : blob.size].cpu().numpy(), blob),
            f"rank {rank}: dp re-encode of image {first + i} differs from "
            "the oracle's stream")
    local = (packed.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 32)
    sums = mesh_mod.all_gather(m, local.reshape(1), "data")
    expect(int(checksum) == int(sums.sum()) % (1 << 32),
           f"rank {rank}: the dp checksum differs from the ranks' sums")
    held = {}
    _hold_recorded(held, calls, f"dp decode and re-encode, rank {rank} of "
                   f"{dist.get_world_size()} ({len(blobs)} images)")
    enc_in = pad(packed)
    del out, calls
    mpix = len(blobs) * dist.get_world_size() * pipe.n_px / 1e6
    paths = [dict(label="dp decode and re-encode", launches=launches,
                  needs=("replay", "place_fill", "fields", "compact",
                         "emit"))]
    for label, fn in (("dp decode", lambda: dec(streams, sizes)),
                      ("dp encode", lambda: enc(enc_in))):
        ms, first_ms = _rank_ms(fn, dev)
        paths.append(dict(label=label, ms=ms, first_ms=first_ms, mpix=mpix))
    return dict(rank=rank, backend=dist.get_backend(), images=len(blobs),
                checksum=int(checksum), paths=paths, held=held)


def _sp_image(cfg, name):
    """(desc, raw, stream) of an sp image: "sparse" is the split path's
    make_image at side x side and its oracle stream, any other name a
    stream of the committed corpus and its oracle pixels."""
    if name == "sparse":
        desc = Desc(cfg["side"], cfg["side"], Channels.RGB)
        raw = make_image(cfg["side"], cfg["side"], seed=3)
        return desc, raw, oracle.encode(raw, desc)[0]
    blob = np.fromfile(Path(cfg["corpus"]) / f"{name}.qoi", np.uint8)
    desc = read_header(blob).value()
    return desc, oracle.decode(blob, desc, desc.channels), blob


def parallel_sp_rank(cfg):
    """One rank of the sp job: sp decode of each cfg["sp_decode"] stream
    at cfg["tiles"] tiles a rank and sp encode of each cfg["sp_encode"]
    image, every result gathered to rank 0 and held to the oracle; K5 (on
    rank 0) and E1, K3 and K4 (on every rank's shard) held against their
    plain versions on the arguments the path gave them; every path
    timed."""
    dev = launch.rank_device(cfg["device_type"])
    rank, world = dist.get_rank(), dist.get_world_size()
    m = mesh_mod.make_mesh((1, world), device_type=cfg["device_type"])
    tiles = cfg["tiles"]
    held, paths = {}, []
    for name in cfg["sp_decode"]:
        desc, raw, blob = _sp_image(cfg, name)
        n_px = desc.width * desc.height
        meta, val, info = dryrun.sp_rows(blob, n_px, world * tiles, dev)
        qb = meta.shape[0]
        fn = sharded.make_sp_decode(m, qb, tiles, with_rounds=True,
                                    device=dev)
        rows = (mesh_mod.local_rows(meta, m, "seq"),
                mesh_mod.local_rows(val, m, "seq"))
        with _recorded((replay_kernel, ("replay_batch_summary",))) as calls:
            (emits, prevs, rounds), launches = _counted(dev,
                                                        lambda: fn(*rows))
        # the gather this check asks for: every block, expanded on rank 0
        emits, prevs = (mesh_mod.all_gather(m, x, "seq").reshape(-1)
                        for x in (emits, prevs))
        what = (f"sp decode {name} {desc.width}x{desc.height}, rank {rank} "
                f"of {world}: {qb // world} rows in {tiles} tiles")
        k5_args = calls[-1][1]  # the last round's (meta_t, val_t, in_p, in_s)
        if rank == 0:
            got = dec_ops.expand_pixels(
                emits, prevs, info["real"], info["produced"],
                info["pix_before"], dec_ops._bucket(n_px, 128))[:n_px]
            expect(bool((got == pixels_to_packed(torch.from_numpy(raw).to(
                dev), int(desc.channels))).all()),
                f"sp decode of {name} differs from the oracle")
            # K5 on this rank's tiles from the last round's in-state
            _hold(held, "replay_summary", _replay_check(
                "replay_summary", *k5_args[:2], k5_args[2:], what)[0],
                f"{what}, round {rounds}")
        del emits, prevs, calls
        ms, first_ms = _rank_ms(lambda: fn(*rows), dev)
        # a round's parts: K5 on every rank's tiles at once, and one
        # round's exchange (the 65-word all_gather and the flag's MIN)
        k5_ms, _ = _rank_ms(
            lambda: replay_kernel.replay_batch_summary(*k5_args), dev)
        state = torch.zeros(65, dtype=torch.int32, device=dev)
        flag = torch.ones(1, dtype=torch.int32, device=dev)
        exchange_ms, _ = _rank_ms(lambda: (
            mesh_mod.all_gather(m, state, "seq"),
            mesh_mod.all_reduce(m, flag, "seq", dist.ReduceOp.MIN)), dev)
        paths.append(dict(label=f"sp decode {name}", launches=launches,
                          needs=("replay_summary",), rounds=rounds, qb=qb,
                          tiles=world * tiles, ms=ms, first_ms=first_ms,
                          mpix=n_px / 1e6, parts=dict(
                              round=ms / rounds, k5=k5_ms,
                              exchange=exchange_ms)))
    for name in cfg["sp_encode"]:
        desc, raw, blob = _sp_image(cfg, name)
        ch, n_px = int(desc.channels), desc.width * desc.height
        shard, n_local, n_last = sharded.sp_shard(pixels_to_packed(
            torch.from_numpy(raw).to(dev), ch), m)
        fn = sharded.make_sp_encode(m, n_local, ch, device=dev)
        with _recorded(*_ENCODE_CALLS) as calls:
            (body, length), launches = _counted(
                dev, lambda: fn(shard, n_last))
        expect(sharded.gather_stream(m, body, length) == blob[14:].tobytes(),
               f"rank {rank}: sp encode of {name} differs from the oracle's "
               "stream")
        v = n_last if rank == world - 1 else n_local
        _hold_recorded(held, calls, f"sp encode {name} {desc.width}x"
                       f"{desc.height}x{ch}, shard {rank} of {world} ({v} "
                       f"of {n_local} px)")
        owner = {n: mod for mod, names in _ENCODE_CALLS for n in names}
        kernel_calls = [(getattr(owner[c], c), args, kwargs)
                        for c, args, kwargs, _ in calls]
        del calls
        ms, first_ms = _rank_ms(lambda: fn(shard, n_last), dev)
        # the part of it that is E1, K3 and K4, on every shard at once
        kernels_ms, _ = _rank_ms(
            lambda: [call(*args, **kwargs)
                     for call, args, kwargs in kernel_calls], dev)
        paths.append(dict(label=f"sp encode {name}", launches=launches,
                          needs=("fields", "compact", "emit"), n_local=n_local,
                          n_last=n_last, ms=ms, first_ms=first_ms,
                          mpix=n_px / 1e6, parts=dict(kernels=kernels_ms)))
    return dict(rank=rank, backend=dist.get_backend(), paths=paths,
                held=held)


def parallel_config(dev):
    """What the parallel jobs' ranks are given (they import this module
    afresh, so nothing set on it in this process reaches them)."""
    return dict(device_type=dev.type, w=W, h=H, side=SPLIT_SIDE,
                corpus=str(CORPUS_DIR), tiles=PARALLEL["sp_tiles"],
                sp_decode=PARALLEL["sp_decode"],
                sp_encode=PARALLEL["sp_encode"])


def phase3_parallel(rgb, dev):
    """The parallel jobs, every rank on the card: dp at dp_world on the
    batch RGB corpus and sp at sp_world (gloo), and on a card the dp job
    at world 1 through NCCL.  Returns {job: [each rank's result]}."""
    cfg = parallel_config(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = str(Path(tmp) / "batch_rgb.npz")
    np.savez(path, streams=rgb["streams"].cpu().numpy(),
             sizes=rgb["sizes"].cpu().numpy())
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks allocate on the same card
    jobs = {}
    try:
        for job, fn, world, args in (
                ("dp", parallel_dp_rank, PARALLEL["dp_world"], (cfg, path)),
                ("sp", parallel_sp_rank, PARALLEL["sp_world"], (cfg,))):
            t0 = time.perf_counter()
            jobs[job] = launch.run_ranks(fn, world, "gloo", dev.type,
                                         PARALLEL["timeout"], args)
            log(f"phase 3: parallel {job} job: {world} ranks (gloo) in "
                f"{time.perf_counter() - t0:.1f} s, every result equal to "
                "the oracle")
        if dev.type == "cuda":
            t0 = time.perf_counter()
            jobs["nccl"] = launch.run_ranks(parallel_dp_rank, 1, "nccl",
                                            dev.type, PARALLEL["timeout"],
                                            (cfg, path))
            log(f"phase 3: parallel dp job at world 1 through NCCL in "
                f"{time.perf_counter() - t0:.1f} s, every result equal to "
                "the oracle")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for job, ranks in jobs.items():
        for p in ranks[0]["paths"]:
            if "rounds" in p:
                log(f"phase 3: parallel {job} job, {p['label']}: {p['tiles']} "
                    f"tiles over {len(ranks)} ranks, qb {p['qb']}, rounds "
                    f"{p['rounds']}")
    return jobs


def phase4_parallel(jobs, totals):
    """Each driven path of each job launched its kernels: the ranks' counts
    (each taken over the path's run alone) summed."""
    for job, ranks in jobs.items():
        for k, p in enumerate(ranks[0]["paths"]):
            if "needs" not in p:
                continue
            launches = {}
            for r in ranks:
                for name, n in r["paths"][k]["launches"].items():
                    launches[name] = launches.get(name, 0) + n
            label = (f"the parallel {job} job's {p['label']} "
                     f"({len(ranks)} ranks, {ranks[0]['backend']})")
            log(f"phase 4: launches on {label}: {launches}")
            for name in p["needs"]:
                expect(launches.get(name, 0) > 0,
                       f"{label} never launched {name}")
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n


def phase5_parallel(jobs, rows, card):
    """The ranks' holds into the kernel rows' "held_at", and each parallel
    path's time."""
    by_name = {r["name"]: r for r in rows}
    n_held = {}
    for ranks in jobs.values():
        for r in ranks:
            for name, shapes in r["held"].items():
                row = by_name[name]
                row.setdefault("held_at", []).extend(shapes)
                row["max_abs_err"] = max(row["max_abs_err"], *(
                    h["max_abs_err"] for h in shapes))
                n_held[name] = n_held.get(name, 0) + len(shapes)
    for name in ("replay", "place_fill", "replay_summary", "fields",
                 "compact", "emit"):
        expect(n_held.get(name), f"phase 5 held {name} at no parallel shape")
    log(f"phase 5: held against their plain versions at the parallel "
        f"paths' shapes: {n_held}")
    for job, ranks in jobs.items():
        for p in ranks[0]["paths"]:
            if "ms" in p:
                log(f"phase 5: parallel {job} job, {p['label']} ({len(ranks)} "
                    f"ranks, {ranks[0]['backend']}): {p['ms']:.2f} ms = "
                    f"{p['mpix'] / p['ms'] * 1e3:.1f} MPix/s (first call "
                    f"{p['first_ms']:.2f} ms); the ranks share one card, not "
                    f"a multi-GPU number; on {card}")
                if "parts" in p:
                    log(f"phase 5: parallel {job} job, {p['label']}, its "
                        f"parts (ms, every rank at once, host clock between "
                        f"barriers): "
                        f"{ {k: round(v, 4) for k, v in p['parts'].items()} }")


def _hold_sampled(held, kept, launched, what):
    """Each sampled call of a tools path (_sampled) against its kernel's
    plain version, as _hold_recorded holds it.  Returns the calls held a
    kernel."""
    for kernel, calls in kept.items():
        for i, (tags, call) in sorted(calls.items()):
            _hold_recorded(held, [call], f"{what}, call {i} of "
                           f"{launched[kernel]} ({', '.join(tags)})")
    return {k: len(v) for k, v in kept.items()}


def _watched(phase_no, label, fn, needs, phase, held):
    """Run one path of phase ``phase_no`` (drive(): its launches counted
    alone, into ``phase``) inside _sampled, require every launch to have
    gone through the watched wrappers, then hold the sampled calls
    against the plain versions (into ``held``)."""
    t0 = time.perf_counter()
    with _sampled(_TOOLS_CALLS) as (kept, launched):
        launches = drive(f"phase {phase_no} ({label})", fn, needs, phase)
    for name, n in launches.items():
        expect(launched.get(name, 0) == n, f"phase {phase_no} ({label}) "
               f"launched {name} {n} times, {launched.get(name, 0)} of "
               "them through the wrappers it watches")
    t1 = time.perf_counter()
    n_held = _hold_sampled(held, kept, launched,
                           f"phase {phase_no} ({label})")
    log(f"phase {phase_no}: {label}: {t1 - t0:.1f} s; then {n_held} of its "
        f"calls a kernel held against the plain versions in "
        f"{time.perf_counter() - t1:.1f} s")


def phase6_tools(rgb, dev, totals):
    """The tools phase: the port's tools and examples as a user runs them,
    each a path whose launches are counted alone.  The fuzzer (seed 0,
    TOOLS_FUZZ_ITERATIONS rounds of all eight targets); tools.bench over
    the committed real corpus and over the batch RGB corpus (written to a
    temporary directory: the torch-batch row), each after its cross
    matrix, one timed call a cell (the timed table is the bench command's
    own run), and its one-shot --sizes sweep; examples.ingest_pipeline at
    --batch 16 on the batch RGB corpus and examples.serving_codec.  Every
    launch of a path goes through a wrapper that _sampled watches; after
    each path a sample of its calls (_sampled's) is held against the
    kernels' plain versions.  The phase must launch, and hold, every
    kernel of TOOLS_NEEDS; its counts are added to ``totals``.  Returns
    (its counts, {kernel: the shapes held})."""
    from qoipp_tpu_torch.examples import ingest_pipeline, serving_codec
    from qoipp_tpu_torch.tools import bench, fuzz

    t_phase = time.perf_counter()
    phase, held = {}, {}

    def run(label, fn, needs):
        _watched(6, label, fn, needs, phase, held)

    def fuzz_all():
        seconds = fuzz.run(TOOLS_FUZZ_ITERATIONS, 0, device=dev,
                           report=lambda m: log(f"phase 6: fuzz: {m}"))
        log(f"phase 6: fuzz OK: {TOOLS_FUZZ_ITERATIONS} iterations x "
            f"{len(seconds)} targets, seed 0, every result equal to the "
            f"oracle; s a target: "
            f"{ {k: round(v, 2) for k, v in seconds.items()} }")

    def main_of(tool, argv):
        argv = [*argv, "--device", str(dev)]
        return lambda: expect(tool.main(argv) == 0,
                              f"{tool.__name__} {argv} failed")

    untimed = ["--runs", "1", "--no-warmup", "--no-png"]
    run("fuzz", fuzz_all, ("replay", "place_fill", "compact", "emit",
                           "replay_summary", "fields"))
    run("bench, real corpus", main_of(bench, [str(CORPUS_DIR), *untimed]),
        ("replay", "logfill", "place_fill", "compact", "emit"))
    with tempfile.TemporaryDirectory() as tmp:
        for i, blob in enumerate(rgb["blobs"]):
            (Path(tmp) / f"rgb_{i:02d}.qoi").write_bytes(blob.tobytes())
        run("bench, batch RGB corpus", main_of(
            bench, [tmp, *untimed, "--no-serving"]),
            ("replay", "place_fill", "compact", "emit"))
        run("ingest example", main_of(ingest_pipeline, [
            "--batch", str(len(rgb["blobs"])), "--dataset", tmp]),
            ("replay", "place_fill"))
    run("bench, one-shot sweep", main_of(bench, ["--sizes"]),
        ("replay", "compact", "emit"))
    run("serving example", main_of(serving_codec, []),
        ("replay", "place_fill"))
    log(f"phase 6: launches over the tools phase: "
        f"{ {k: v for k, v in phase.items() if v} }")
    for name in TOOLS_NEEDS:
        expect(phase.get(name, 0) > 0, f"the tools phase never launched "
               f"{name}")
        expect(name in held, f"the tools phase held {name} at no shape")
    log(f"phase 6: held against their plain versions at the tools "
        f"phase's shapes: { {k: len(v) for k, v in held.items()} }")
    for name, n in phase.items():
        totals[name] = totals.get(name, 0) + n
    log(f"phase 6: the tools phase took {time.perf_counter() - t_phase:.1f}"
        f" s")
    return phase, held


@contextlib.contextmanager
def _staging_counted():
    """Count the staged uploads of every engine that stages through
    stage_h2d, and those of them that went in one piece (upload)."""
    counts = dict(staged=0, one_shot=0)
    saved = [(m, "stage_h2d", m.stage_h2d)
             for m in (split, packed_lanes, serving, device_stream)]
    saved.append((transport, "upload", transport.upload))

    def counted(key, fn):
        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return call

    for m, name, fn in saved:
        setattr(m, name, counted("one_shot" if m is transport else "staged",
                                 fn))
    try:
        yield counts
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def phase7_staging(s, sparse, dev):
    """Each engine that stages through stage_h2d, at PROFILE_CHUNK_BYTES
    chunks, against the oracle: SplitDecoder on the sparse stream, the
    streaming decoder on it at 4 MB windows, PackedDecoder and
    PackedEncoder alone and ServingCodec (decode and encode: packed tiers,
    the split group, geometry buckets) on the serving corpus.  Returns
    each engine's staged uploads and those cut into pieces."""
    blobs, raws, descs, names, refs = (
        s[k] for k in ("blobs", "raws", "descs", "names", "refs"))
    dec = split.SplitDecoder(lanes=SPLIT_LANES, device=dev)

    def split_decode():
        out, where, ds, _ = dec.decode_to_device([sparse["blob"]])
        expect(np.array_equal(dec.gather(out, where, ds)[0], sparse["want"]),
               "chunked staging: SplitDecoder differs from the oracle")

    def stream_decode():
        d = sparse["desc"]
        px, _ = device_stream.stream_decode(
            sparse["blob"], 4 << 20, pixel_cap=-(-d.width * d.height // 8192)
            * 8192, device=dev)
        expect(np.array_equal(px, sparse["want"]), "chunked staging: the "
               "streaming decoder differs from the oracle")

    engines = (
        ("SplitDecoder", split_decode),
        ("DeviceStreamDecoder", stream_decode),
        ("PackedDecoder", lambda: _check_all(
            s["packed"]["dec"].decode(blobs), raws, names,
            "chunked staging: PackedDecoder")),
        ("PackedEncoder", lambda: _check_all(
            s["packed"]["enc"].encode(raws, descs), refs, names,
            "chunked staging: PackedEncoder")),
        ("ServingCodec", lambda: (
            _check_all(s["codec"].decode(blobs), raws, names,
                       "chunked staging: ServingCodec.decode"),
            _check_all(s["codec"].encode(raws, descs), refs, names,
                       "chunked staging: ServingCodec.encode"))))
    out = {}
    transport.set_h2d_chunk_bytes(PROFILE_CHUNK_BYTES)
    try:
        for name, fn in engines:
            with _staging_counted() as counts:
                fn()
            out[name] = dict(staged=counts["staged"],
                             cut=counts["staged"] - counts["one_shot"])
            expect(out[name]["cut"] > 0, f"chunked staging: {name} cut no "
                   "upload into pieces")
    finally:
        transport.set_h2d_chunk_bytes(0)
    counts = ", ".join(f"{k} {v['staged']} ({v['cut']})"
                       for k, v in out.items())
    log(f"phase 7: every staging engine at {PROFILE_CHUNK_BYTES} B chunks "
        f"equals the oracle; staged uploads (cut into pieces): {counts}")
    return out


def phase7_paths(runs, sparse, serve, dev):
    """The profiles phase's paths: the stage profiles and host-stage
    experiments of qoipp_tpu_torch/benchmarks and every staging engine
    chunked, each a path whose launches are counted alone, through
    _watched as phase 6 runs its paths (a sample of each path's kernel
    calls held against the plain versions).  Cut for time: profile_r3 on
    phase 3's corpora (16 RGB, 8 RGBA 1920x1088, encode of all), not its
    128 and 32; the lane sweep at PROFILE_LANES.  Must launch and hold
    PROFILE_NEEDS.  Returns (its counts, {kernel: the shapes held}, every
    profile's and experiment's result)."""
    from qoipp_tpu_torch.benchmarks import (
        expt_boundary2l, expt_compact, expt_enc_lanes, expt_h2d_chunks,
        expt_table_stack, profile_bucket_decode, profile_packed_decode,
        profile_packed_encode, profile_r3)

    t_phase = time.perf_counter()
    phase, held, out = {}, {}, {}
    timed_argv = ["--runs", str(PROFILE_RUNS)]

    def run(label, fn, needs=()):
        log(f"phase 7: {label}")
        _watched(7, label, lambda: out.__setitem__(label, fn()), needs,
                 phase, held)

    for c in runs:
        run(f"profile_r3 {c['label']} B={len(c['blobs'])}",
            lambda c=c: profile_r3.run(c["desc"], c["raws"], c["blobs"], dev,
                                       PROFILE_RUNS, len(c["blobs"])),
            PROFILE_NEEDS)
    run("profile_bucket_decode", lambda: profile_bucket_decode.main(
        timed_argv, device=dev), ("replay", "place_fill"))
    run("profile_packed_decode", lambda: profile_packed_decode.main(
        timed_argv, device=dev), ("replay", "place_fill"))
    run("profile_packed_encode", lambda: profile_packed_encode.main(
        timed_argv, device=dev), ("compact", "emit"))
    c = runs[0]
    q = torch.arange(c["pipe"].qb, device=dev)[None, :]
    expt_boundary2l.hold(torch.where(
        q < (c["sizes"] - 14)[:, None],
        c["streams"][:, 14: 14 + c["pipe"].qb], 0).contiguous(),
        f"the {c['label']} corpus's regions")
    run("expt_boundary2l", lambda: expt_boundary2l.main(timed_argv,
                                                        device=dev))
    run("expt_table_stack", lambda: expt_table_stack.main(timed_argv,
                                                          device=dev))
    run("expt_compact", lambda: expt_compact.main(timed_argv, device=dev),
        ("compact",))
    run(f"expt_enc_lanes L={PROFILE_LANES}", lambda: expt_enc_lanes.main(
        [*timed_argv, "--lanes", *map(str, PROFILE_LANES)], device=dev),
        ("compact", "emit"))
    run("expt_h2d_chunks", lambda: expt_h2d_chunks.main(timed_argv,
                                                        device=dev))
    run("staging engines", lambda: phase7_staging(serve, sparse, dev),
        ("replay", "place_fill", "replay_summary", "compact", "emit"))
    log(f"phase 7: launches over the profiles phase: "
        f"{ {k: v for k, v in phase.items() if v} }")
    for name in PROFILE_NEEDS:
        expect(phase.get(name, 0) > 0, f"the profiles phase never launched "
               f"{name}")
        expect(name in held, f"the profiles phase held {name} at no shape")
    log(f"phase 7: held against their plain versions at the profiles "
        f"phase's shapes: { {k: len(v) for k, v in held.items()} }")
    log(f"phase 7: its paths took {time.perf_counter() - t_phase:.1f} s "
        f"(cut: profile_r3 on phase 3's corpora, not B=128 and 32; the "
        f"lane sweep at L in {PROFILE_LANES})")
    return phase, held, out


def phase7_child(path):
    """The profiles phase in a process of its own: phase 3's corpora made
    again, phase7_paths, its result pickled to ``path``."""
    dev = torch.device("cuda")
    runs = phase3_prepare(dev)
    sparse = phase3_prepare_split(runs, dev)[0]
    serve = phase3_prepare_serving(dev)
    serve["packed"] = dict(
        dec=packed_lanes.PackedDecoder(lane_bytes=PACKED_LANE_BYTES,
                                       device=dev),
        enc=packed_lanes.PackedEncoder(lane_px=PACKED_LANE_PX, device=dev))
    result = phase7_paths(runs, sparse, serve, dev)
    with open(path, "wb") as f:
        pickle.dump(result, f)


def phase7_profiles(totals):
    """The profiles phase, run by a fresh process (phase7_child): in this
    long process torch.profiler drops device events (a stage's launches
    read x.5 over two traced calls) and at times sees none.  Adds its
    counts to ``totals``; returns (its counts, {kernel: the shapes
    held})."""
    t0 = time.perf_counter()
    log("phase 7: the profiles phase, in a process of its own")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "phase7.pkl"
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.phase7_child({str(path)!r})"],
            cwd=Path(__file__).resolve().parent, timeout=900)
        expect(proc.returncode == 0, f"the profiles phase's process exited "
               f"{proc.returncode}")
        with open(path, "rb") as f:  # written by phase7_child above
            phase, held, _ = pickle.load(f)
    for name, n in phase.items():
        totals[name] = totals.get(name, 0) + n
    log(f"phase 7: the profiles phase took {time.perf_counter() - t0:.1f} s"
        " with its process's start")
    return phase, held


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
          ("chunk_starts", "replay", "place_fill", "fields", "compact",
           "emit"), launches)
    sparse, dense = split_runs
    drive("the split path (sparse)", lambda: phase3_split(sparse),
          ("chunk_starts", "replay_summary", "compact", "place_fill",
           "gather_pixels"), launches)
    drive("the split path (dense)", lambda: phase3_split(dense),
          ("chunk_starts", "replay_summary", "place_fill", "gather_pixels"),
          launches)
    drive("the one-shot path (decode rgb)",
          lambda: phase3_oneshot_decode(oneshot[0]),
          ("chunk_starts", "replay", "logfill"), launches)
    drive("the one-shot path (decode rgba)",
          lambda: phase3_oneshot_decode(oneshot[1]),
          ("chunk_starts", "replay"), launches)
    drive("the one-shot path (encode rgb)",
          lambda: phase3_oneshot_encode(oneshot[0]),
          ("fields", "compact", "emit"), launches)
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
    serve = phase3_prepare_serving(dev)
    drive("the serving path", lambda: phase3_serving(serve),
          ("chunk_starts", "replay", "place_fill", "replay_summary",
           "fields", "compact", "emit", "gather_pixels"), launches)
    drive("the packed lanes", lambda: phase3_packed(serve, dev),
          ("chunk_starts", "replay", "place_fill", "compact", "emit",
           "gather_pixels"), launches)
    drive("the api torch backend", lambda: phase3_api(serve, dev),
          ("chunk_starts", "replay", "logfill", "fields", "compact",
           "emit"), launches)
    par = phase3_parallel(runs[0], dev)
    phase4_parallel(par, launches)
    log(f"phase 4: launches over all paths: {launches}")
    rows = phase5_kernels_at_main_shapes(runs[0], launches, card)
    rows.append(phase5_chunk_starts(runs[0], sparse, launches, dev, card))
    rows.append(phase5_gather(serve, launches, card))
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
    phase5_serving_kernels(serve, rows, launches, card)
    phase5_parallel(par, rows, card)
    for run in runs:
        phase5_pipeline_times(run, card)
    for run in split_runs:
        phase5_split_times(run, card)
    phase5_oneshot_times(oneshot, card)
    for st in streams:
        d = st["im"]["desc"]
        _time_path(st["label"], lambda st=st: _stream_session(st, dev),
                   d.width * d.height / 1e6, card)
    phase5_serving_times(serve, card)
    phase5_packed_times(serve, card)
    later = (("tools_launches", *phase6_tools(runs[0], dev, launches)),
             ("profiles_launches", *phase7_profiles(launches)))
    for row in rows:
        for key, counts, held in later:
            row[key] = counts.get(row["name"], 0)
            row["launches"] += row[key]
            shapes = held.get(row["name"], [])
            row.setdefault("held_at", []).extend(shapes)
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                h["max_abs_err"] for h in shapes])
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
