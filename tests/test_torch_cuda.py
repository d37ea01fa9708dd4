"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (the edge cases of qoipp_tpu_torch.kernels.selfcheck, as
chip_smoke.py's phase 2), and the batch pipeline, the split decoder, the
one-shot codec and the streaming codec at a small size against the port's
oracle, K2 and E1 across many blocks (selfcheck.place_fill_cases and
fields_segments), E3 on selfcheck.FILL2_CASES, E4 at every
selfcheck.GROUPED_SHAPES, E5 on selfcheck.narrow_case at every ns the
selfcheck takes, E6's instantiations on selfcheck.reach_case at every
n_fill, E2 at every lanes on both, E7 at every lanes on
selfcheck.EMIT_RUN_CASES, a single-image batch decode, the batch encoder
(fields-first) against the compact-first chain on 1080p batches, the
photo and a one-shot bucket at default and tight caps
(selfcheck.batch_encode_err), E1 at the batch cell's 32 x 2,073,600, and the experiment scripts (E2-E7, and E8/E9 in
profile_r2) at a small size; and K1 and K5 against their plain versions
on the whole output over no rows and tile-edge row counts, lane counts,
both row layouts and one-class, reset, random and palette rows; K3 and K6
on their edge cases (selfcheck.COMPACT_CASES, LOGFILL_CASES), K3 twice in
a row, without a torch scan and refusing short status words; and the
latency probe behind the replay chain bound against its plain loop.
G1 against its plain version at the serving corpus's shapes.
ServingCodec over the committed real corpus, PackedDecoder and
PackedEncoder on lanes of several streams, the api's torch backend and
one request through the bucketed and serving codecs, against the oracle;
the bucketed decode into one card tensor on two 4K frames, a photo
mosaic's lane at qb 16,777,216 among them, and on a mixed-length batch
against its fetched decode.  pack_streams' pinned block, not handed out
again while a copy queued behind a sleep still reads it, and a traced
batch decode uploading exactly the pinned bytes, none pageable.
The parallel layer as a job of 4 ranks on the one card (gloo, the
exchange staged through host memory): dp decode and encode, sp decode
(the adversarial INDEX stream too) and sp encode of
tests/torch_parallel_jobs.py, and the dry run, against the oracle; the
scan engine's decode_bytes on the card against its CPU result.  The
fuzzer's eight targets at three rounds each, the ingest example at B=2,
and every tool refusing the card where torch reports none.  Chunked
staging (utils/transport.stage_h2d at 256-byte chunks) through every
engine that stages, the overlapped serving dispatch's side stream among
them, against its unchunked run and the oracle; the chunk-start scan's
kernel against its plain version on byte soup up to batch1080_decode's
128 x 278,528, stream window planes' strided views, a planned window,
one-tag rows and corpus regions, one launch a call and its counters in a
traced decode; the two-level boundary scan against the kernel; and each
stage profile and host-stage experiment of qoipp_tpu_torch/benchmarks at a
small size, timed.
Without a CUDA device every test here skips.

Run on a GPU machine (tests/conftest.py imports JAX, which it lacks):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from qoipp_tpu_torch import kernels, oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.ops.bitops import hash6
from qoipp_tpu_torch.tools import fuzz
from qoipp_tpu_torch.utils.corpus import make_corpus, make_image

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    # decided per test, never at collection: every worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(selfcheck.CASES))
def test_kernel_matches_plain_version(cuda, name):
    before = kernels.launch_counts()[name]
    assert selfcheck.check(name, cuda) <= selfcheck.TOLERANCE.get(name, 0)
    assert kernels.launch_counts()[name] > before


def test_place_fill_windows_match_plain_version(cuda):
    """K2 on the whole output across many blocks: 24 windows an image over
    1.1 M rows, an empty tail of 21 windows, pixels left to the carry
    inside windows, and 96 split lanes of 12,289 rows."""
    from qoipp_tpu_torch.ops import place_kernel

    before = kernels.launch_counts()["place_fill"]
    cases = selfcheck.place_fill_cases(np.random.default_rng(12), cuda)
    for pb, emits, n_cap in cases:
        got = place_kernel.place_fill(pb, emits, n_cap)
        torch.cuda.synchronize()
        assert torch.equal(got, place_kernel.place_fill_reference(
            pb, emits, n_cap))
    assert kernels.launch_counts()["place_fill"] == before + len(cases)


@pytest.mark.parametrize("case", selfcheck.FILL2_CASES)
def test_place_fill2_cases_match_plain_version(cuda, case):
    """E3 on the whole output: windows whose longest chunk is exactly 8 and
    exactly 9, units whose second window has no writer, runs of units with
    no writer (the inherit chain crosses units), images whose last unit
    holds only tail rows; each called twice in a row."""
    pb, emits, n_cap = selfcheck.fill2_case(
        case, np.random.default_rng(17), cuda)
    before = kernels.launch_counts()["place_fill2"]
    for _ in range(2):
        assert selfcheck.fill2_err(pb, emits, n_cap) == 0
    assert kernels.launch_counts()["place_fill2"] == before + 2


@pytest.mark.parametrize("win,g", selfcheck.GROUPED_SHAPES)
def test_place_grouped_shapes_match_plain_version(cuda, win, g):
    """E4 on the whole output at (win, g): lr_mode cnt, dyn and smem on
    more than 256 rows on one pixel, duplicates across a tile edge, gaps
    across window and step edges; every lr_mode with static_inputs off
    and on where the fixed range covers the rows."""
    from qoipp_tpu_torch.ops import place_window

    before = kernels.launch_counts()["place_grouped"]
    assert selfcheck.grouped_err(win, g, cuda) == 0
    assert kernels.launch_counts()["place_grouped"] > before
    threads, per_sm = place_window.launch_shape("place_grouped", win, g)
    assert threads > 0 and per_sm >= 1


def test_place_fill2_launch_shape(cuda):
    from qoipp_tpu_torch.ops import place_window

    threads, per_sm = place_window.launch_shape("place_fill2")
    assert threads > 0 and per_sm >= 1


@pytest.mark.parametrize("q", [8000, 7999])
@pytest.mark.parametrize("ns", [1, 2, 4, 64])
def test_place_narrow_cases_match_plain_version(cuda, ns, q):
    """E5 on the whole output: a group inside a window's last stripe (the
    span's clamp), the next one across the window edge, rows past n_cap;
    16-byte row loads (Q % 4 == 0) and scalar ones."""
    from qoipp_tpu_torch.ops import place_kernel, place_window

    pb, emits, n_cap = selfcheck.narrow_case(np.random.default_rng(ns), q,
                                             cuda)
    got = place_window.place_fill_narrow(
        pb, emits, place_window.window_base_rows(pb, n_cap), n_cap, ns=ns)
    torch.cuda.synchronize()
    assert torch.equal(got, place_kernel.place_fill_reference(pb, emits,
                                                              n_cap))


@pytest.mark.parametrize("n_fill", range(7))
def test_place_variant_reach_cases_match_plain_version(cuda, n_fill):
    """E6's three (do_dma, do_slabs) instantiations at n_fill on the whole
    output, on writers R, R + 1 and R + 2 apart (R = 2**n_fill - 1) at
    every position of a mask word and at the windows' first and last
    pixels."""
    from qoipp_tpu_torch.ops import place_kernel, place_window

    pb, emits, n_cap = selfcheck.reach_case(
        n_fill, np.random.default_rng(n_fill), cuda)
    base = place_window.window_base_rows(pb, n_cap)
    for dma, slabs in ((True, True), (True, False), (False, False)):
        got = place_window.place_variant(pb, emits, base, n_cap, do_dma=dma,
                                         do_slabs=slabs, n_fill=n_fill)
        torch.cuda.synchronize()
        assert torch.equal(got, place_kernel.place_fill_reference(
            pb, emits, n_cap, n_fill, slabs))


@pytest.mark.parametrize("name", ["place_wide", "place_fill_narrow",
                                  "place_variant"])
def test_place_window_launch_shapes(cuda, name):
    from qoipp_tpu_torch.ops import place_window

    threads, per_sm = place_window.launch_shape(name)
    assert threads == 512 and per_sm >= 1
    if name == "place_wide":
        for lanes in (128, 512):
            assert place_window.launch_shape(name, lanes=lanes)[1] >= 1


@pytest.mark.parametrize("case", ["reach", "narrow 8000", "narrow 7999"])
def test_place_wide_cases_match_plain_version(cuda, case):
    """E2 at every lanes on the whole output: E6's reach_case at reach 63
    (writers 63, 64 and 65 apart, the windows' first and last pixels) and
    E5's narrow_case (groups inside a window's last stripe and across its
    edge; 16-byte and scalar row loads)."""
    from qoipp_tpu_torch.ops import place_kernel, place_window

    rng = np.random.default_rng(len(case))
    pb, emits, n_cap = (selfcheck.reach_case(6, rng, cuda) if case == "reach"
                        else selfcheck.narrow_case(rng, int(case[-4:]), cuda))
    want = place_kernel.place_fill_reference(pb, emits, n_cap)
    for lanes in place_window.WIDE_LANES:
        got = place_window.place_wide(
            pb, emits, place_window.window_base_rows_w(pb, n_cap, lanes),
            n_cap, lanes=lanes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), lanes


@pytest.mark.parametrize("case", sorted(selfcheck.EMIT_RUN_CASES))
def test_emit_run_cases_match_plain_version(cuda, case):
    """E7 at every lanes on the whole output where an image's rows end in a
    run of equal offs: mid-window, at a window's first byte, at one of its
    last 5 bytes (the run's last row crosses the edge), at or past out_cap,
    with a ragged C, and beside an interior run."""
    from qoipp_tpu_torch.ops import emit_window

    before = kernels.launch_counts()["emit_window"]
    case = selfcheck.emit_run_case(case, np.random.default_rng(1), cuda)
    assert selfcheck.emit_window_err(*case) == 0
    assert kernels.launch_counts()["emit_window"] == before + len(
        emit_window.WIDE_LANES)


def test_emit_window_launch_shape(cuda):
    from qoipp_tpu_torch.ops import emit_window

    for lanes in emit_window.WIDE_LANES:
        threads, per_sm = emit_window.launch_shape(lanes)
        assert threads == 512 and per_sm >= 1


@pytest.mark.parametrize("b,nb", selfcheck.FIELDS_SEGMENT_SHAPES)
def test_fields_segments_match_plain_version(cuda, b, nb):
    """E1 on rows cut into segments (fields_kernel.segments on this card):
    runs, RUN-62 hits and a table slot across segment edges, n_px inside
    and before segments, non-start carries; RGB and RGBA."""
    from qoipp_tpu_torch.ops import fields_kernel

    before = kernels.launch_counts()["fields"]
    assert selfcheck.fields_segments(cuda, b, nb) == 0
    assert kernels.launch_counts()["fields"] == before + 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    seg_tiles, nseg = fields_kernel.segments(b, nb, sms)
    assert nseg * seg_tiles * 1024 >= nb > (nseg - 1) * seg_tiles * 1024


# the batch encoder's inputs on the card: 32 frames of the batch cell's
# generator (its sub-batch), RGBA frames, the committed 1080p photo, and
# a one-shot bucket (B = 1, n_px short of the bucket)
BATCH_ENCODE_CASES = ("frames_1080p_rgb_b32", "frames_1080p_rgba_b8",
                      "photo_1080p", "oneshot_bucket_rgba")


@functools.cache
def _batch_encode_case(case):
    """(packed (B, Nb) int32 on the CPU, n_px, channels) of one case."""
    from qoipp_tpu_torch.ops import backend
    from qoipp_tpu_torch.ops.bitops import pixels_to_packed

    if case.startswith("frames"):
        b, ch = (32, 3) if case.endswith("b32") else (8, 4)
        _, raws, _ = make_corpus(b, 1920, 1080, seed=b, channels=ch)
        raw = torch.from_numpy(np.stack(raws))
        return pixels_to_packed(raw, ch), 1920 * 1080, ch
    name = "photo_china_1080p" if case == "photo_1080p" else (
        "screenshot_requests")
    blob = np.fromfile(CORPUS_DIR / f"{name}.qoi", np.uint8)
    d = oracle.read_header(blob)
    raw = oracle.decode(blob, d, d.channels)
    if case == "photo_1080p":  # the photo and its pixels reversed
        px = raw.reshape(-1, 3)
        raw = torch.from_numpy(np.stack([px, px[::-1]]).reshape(2, -1))
        return pixels_to_packed(raw, 3), d.width * d.height, 3
    packed, _ = backend.encode_inputs(raw, d, "cpu")
    return packed, d.width * d.height, int(d.channels)


@pytest.mark.parametrize("caps", ["default", "tight"])
@pytest.mark.parametrize("case", BATCH_ENCODE_CASES)
def test_batch_encode_matches_compact_first(cuda, case, caps):
    """The fields-first batch encoder (E1, K3, K4) against the compact-
    first chain in plain versions (selfcheck.encode_compact_first):
    streams, lengths and ok flags, at the default caps and at tight ones
    (selfcheck.tight_caps: rows past chunk_cap, rows over out_cap)."""
    packed, n_px, channels = _batch_encode_case(case)
    packed = packed.to(cuda)
    cap = selfcheck.tight_caps(packed, n_px) if caps == "tight" else ()
    before = kernels.launch_counts()
    assert selfcheck.batch_encode_err(packed, n_px, channels, *cap) == 0
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in ("fields", "compact",
                                                    "emit"))


def test_fields_at_batch_encode_shape(cuda):
    """E1 from the start state on the batch cell's sub-batch, 32 x
    2,073,600 generator pixels: segments of 225 tiles (230,400 px on an
    H100), wider than any of FIELDS_SEGMENT_SHAPES, against its plain
    version."""
    from qoipp_tpu_torch.ops import fields_kernel

    packed, n_px, channels = _batch_encode_case("frames_1080p_rgb_b32")
    b, nb = packed.shape
    edge = selfcheck.fields_edge(cuda, b, nb)
    assert edge > max(selfcheck.fields_edge(cuda, *shape)
                      for shape in selfcheck.FIELDS_SEGMENT_SHAPES)
    args = (packed.to(cuda), torch.full((b,), n_px, dtype=torch.int32,
                                        device=cuda), channels)
    got = fields_kernel.encode_fields_planes(*args)
    want = fields_kernel.encode_fields_planes_reference(
        *args, *fields_kernel.start_state(b, cuda))
    assert max(selfcheck.max_abs_err(g, w) for g, w in zip(got, want)) == 0


@pytest.mark.parametrize("case", selfcheck.COMPACT_CASES)
def test_compact_cases_match_plain_version(cuda, case):
    """K3 against its plain version on counts and every row below counts
    and cap, called twice in a row on one stream (each call starts from
    freshly zeroed status words and ticket): one row, ragged unaligned
    lanes, 1-4 planes, an all-kept lane beside an empty one, keep toggled
    in runs of exactly the tile, counts past cap, 2^24 rows."""
    planes, keep, cap = selfcheck.compact_case(
        case, np.random.default_rng(13), cuda)
    before = kernels.launch_counts()["compact"]
    for _ in range(2):
        assert selfcheck.compact_err(planes, keep, cap) == 0
    assert kernels.launch_counts()["compact"] == before + 2
    if case == "past cap":
        from qoipp_tpu_torch.ops import compact_kernel

        assert int(compact_kernel.compact_rows(planes, keep, cap)[1].min()) \
            > cap


def test_compact_runs_no_scan(cuda):
    """On the card K3 counts its own kept rows: one compact_rows call runs
    the kernel and the zeroing of its status words, and no torch scan."""
    from qoipp_tpu_torch.ops import compact_kernel
    from qoipp_tpu_torch.utils import profile

    planes, keep, cap = selfcheck.compact_case(
        "ragged lanes", np.random.default_rng(14), cuda)
    groups = profile.profile_path(
        lambda: compact_kernel.compact_rows(planes, keep, cap))["groups"]
    assert "K3 compact" in groups
    assert set(groups) <= {"K3 compact", "torch elementwise", "fills"}


def test_compact_rejects_short_status(cuda):
    """qk_compact refuses status words fewer than a tile's each and the
    ticket: it launches nothing and writes nothing past them."""
    from qoipp_tpu_torch.ops import compact_kernel

    b, n = 2, compact_kernel.launch_shape()[0] + 1  # two tiles a lane
    keep = torch.ones((b, n), dtype=torch.bool, device=cuda)
    plane = torch.zeros((b, n), dtype=torch.int32, device=cuda)
    out = torch.zeros((b, n), dtype=torch.int32, device=cuda)
    counts = torch.zeros((b,), dtype=torch.int32, device=cuda)
    status = torch.zeros(2 * b + 1, dtype=torch.int64, device=cuda)
    before = kernels.launch_counts()["compact"]
    with pytest.raises(RuntimeError, match="qk_compact"):
        kernels.launch("compact", "qk_compact", cuda, keep.data_ptr(),
                       status.data_ptr(), 2 * b, 1, plane.data_ptr(), 0, 0,
                       0, out.data_ptr(), 0, 0, 0, counts.data_ptr(), b, n,
                       n)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["compact"] == before
    assert not status.any() and not out.any()


@pytest.mark.parametrize("case", selfcheck.LOGFILL_CASES)
def test_logfill_cases_match_plain_version(cuda, case):
    """K6 against its plain version: rows shorter than 64 words, rows that
    are no multiple of the warp segment, flags 63 and 64 apart across
    segment and block edges, non-zero unflagged words."""
    from qoipp_tpu_torch.ops import replay_kernel

    words = torch.from_numpy(selfcheck.logfill_case(
        case, np.random.default_rng(15)).view(np.int32)).to(cuda)
    before = kernels.launch_counts()["logfill"]
    got = replay_kernel.logfill_batch(words)
    torch.cuda.synchronize()
    assert torch.equal(got, replay_kernel.logfill_batch_reference(words))
    assert kernels.launch_counts()["logfill"] == before + 1


REPLAY_TILE = selfcheck.REPLAY_TILE
REPLAY_LANES = (1, 16, 40, 130)


def _replay_rows(pattern, c, b, rng):
    """(C, B) uint32 (meta, val) of one pattern: a single class (nop, run,
    idx, seta, add), random classes with resets in the middle of tiles
    (resets), every class with rare resets (random), or SETA/SETC/ADD/IDX
    rows over a four-pixel palette whose IDX rows read the palette's
    slots, so that they often read a slot one of the two rows before them
    wrote (palette)."""
    single = {"nop": 0, "seta": 1, "add": 3, "idx": 4, "run": 5}
    words = lambda shape: rng.integers(0, 1 << 32, shape,
                                       dtype=np.uint64).astype(np.uint32)
    arg = rng.integers(0, 64, (c, b))
    rst = np.zeros((c, b), np.int64)
    val = words((c, b))
    if pattern in single:
        cls = np.full((c, b), single[pattern])
    elif pattern == "palette":
        pal = words(4)
        slots = [int(hash6(torch.tensor(int(p)).to(torch.int32))) for p in
                 pal.view(np.int32)]
        cls = rng.choice([1, 2, 3, 4, 4, 4], (c, b))
        arg = rng.choice(slots + [53], (c, b))
        val = np.where(cls == 3, 0, pal[rng.integers(0, 4, (c, b))])
    else:
        cls = rng.integers(0, 8, (c, b))
        if pattern == "resets":
            for r in (REPLAY_TILE // 2, REPLAY_TILE + 7, 2 * REPLAY_TILE + 1):
                if r < c:
                    rst[r, ::2] = 1
        else:
            rst = (rng.random((c, b)) < 0.002).astype(np.int64)
    return (cls | arg << 3 | rst << 9).astype(np.uint32), val.astype(np.uint32)


@pytest.mark.parametrize("summary", [False, True])
@pytest.mark.parametrize("pattern", ["nop", "run", "idx", "seta", "add",
                                     "resets", "random", "palette"])
def test_replay_kernels_match_plain_version(cuda, pattern, summary):
    """K1 (summary False) and K5 on the whole output at C = 0, 1, T - 1, T
    and 3T + 5 rows (T the kernel's tile) and B = 1, 16, 40, 130 lanes, with
    chunk-major and lane-major rows; lanes are independent, so the plain
    version runs once at the largest B."""
    from qoipp_tpu_torch.ops import replay_kernel as rk

    fn, ref = ((rk.replay_batch_summary, rk.replay_batch_summary_reference)
               if summary else
               (rk.replay_batch_carry, rk.replay_batch_carry_reference))
    name = "replay_summary" if summary else "replay"
    before = kernels.launch_counts()[name]
    bmax = max(REPLAY_LANES)
    sizes = (0, 1, REPLAY_TILE - 1, REPLAY_TILE, 3 * REPLAY_TILE + 5)
    for c in sizes:
        rng = np.random.default_rng(c)
        words = lambda shape: rng.integers(0, 1 << 32, shape,
                                           dtype=np.uint64).astype(np.uint32)
        meta, val = _replay_rows(pattern, c, bmax, rng)
        prev, seen = words((1, bmax)), words((64, bmax))
        args = [torch.from_numpy(x.view(np.int32)).to(cuda)
                for x in (meta, val, prev, seen)]
        want = ref(*args)
        for b in REPLAY_LANES:
            rows = [x[:, :b].contiguous() for x in args]
            lane_major = [x.T.contiguous().T for x in rows[:2]] + rows[2:]
            for case in (rows, lane_major):
                got = fn(*case)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w[:, :b]), (pattern, c, b)
    assert kernels.launch_counts()[name] == (
        before + len(sizes) * 2 * len(REPLAY_LANES))


@pytest.mark.parametrize("channels", [3, 4])
def test_pipeline_on_card_matches_oracle(cuda, channels):
    from qoipp_tpu_torch.models.pipeline import BatchPipeline
    from qoipp_tpu_torch.ops.bitops import pixels_to_packed

    desc, raws, blobs = make_corpus(4, 96, 64, seed=channels,
                                    channels=channels)
    ml = max(b.size for b in blobs)
    pipe = BatchPipeline(desc, max_stream_len=ml, max_encode_len=ml + 4096,
                         device=cuda)
    packed = pipe.decode_packed(*pipe.pack_streams(blobs))
    assert packed.device.type == "cuda"
    want = np.stack([oracle.decode(b, desc, desc.channels) for b in blobs])
    want = pixels_to_packed(torch.from_numpy(want).to(cuda), channels)
    assert torch.equal(packed[:, : pipe.n_px], want)
    out, lengths = pipe.encode(np.stack(raws))
    for i, blob in enumerate(blobs):
        assert int(lengths[i]) == blob.size
        assert np.array_equal(out[i, : blob.size].cpu().numpy(), blob)


@pytest.mark.parametrize("channels", [3, 4])
def test_single_image_pipeline_on_card_matches_oracle(cuda, channels):
    # B = 1: K1 reads the lane-major (qb, 1) rows at their strides
    from qoipp_tpu_torch.models.pipeline import BatchPipeline
    from qoipp_tpu_torch.ops.bitops import pixels_to_packed

    desc, _, blobs = make_corpus(1, 96, 64, seed=channels, channels=channels)
    pipe = BatchPipeline(desc, max_stream_len=blobs[0].size, device=cuda)
    streams, sizes = pipe.pack_streams(blobs)
    packed = pipe.decode_packed(streams, sizes)
    want = pixels_to_packed(torch.from_numpy(
        oracle.decode(blobs[0], desc, desc.channels)[None]).to(cuda), channels)
    assert torch.equal(packed[:, : pipe.n_px], want)
    img = pipe.decode(streams, sizes)
    assert np.array_equal(img[0].cpu().numpy().reshape(-1),
                          oracle.decode(blobs[0], desc, desc.channels))


@pytest.mark.parametrize("lanes,chunk_domain", [(8, True), (32, False)])
def test_split_on_card_matches_oracle(cuda, lanes, chunk_domain):
    from qoipp_tpu_torch.models.split import SplitDecoder

    desc = Desc(1024, 768, Channels.RGB)
    sparse = oracle.encode(make_image(1024, 768, seed=3), desc)[0]
    _, _, blobs = make_corpus(2, 160, 96, seed=1, channels=4)
    streams = [sparse] + blobs
    dec = SplitDecoder(lanes=lanes)
    # the host plan picks the chunk domain (qc > 0) or the byte domain
    assert (dec.plan_and_pack(streams)[9] > 0) == chunk_domain
    before = kernels.launch_counts()
    packed, where, descs, rounds = dec.decode_to_device(streams)
    assert packed.device.type == "cuda" and rounds >= 1
    after = kernels.launch_counts()
    for name in ("replay_summary", "place_fill") + (
            ("compact",) if chunk_domain else ()):
        assert after[name] > before[name]
    for got, blob, d in zip(dec.gather(packed, where, descs), streams,
                            descs):
        assert np.array_equal(got, oracle.decode(blob, d, d.channels))


@pytest.mark.parametrize("channels", [3, 4])
def test_oneshot_on_card_matches_oracle(cuda, channels):
    from qoipp_tpu_torch.ops import backend

    desc, raws, blobs = make_corpus(1, 200, 120, seed=channels,
                                    channels=channels)
    before = kernels.launch_counts()
    for blob in (blobs[0], blobs[0][: blobs[0].size // 2]):  # and truncated
        got = backend.decode_single(blob, desc, desc.channels)
        assert np.array_equal(got, oracle.decode(blob, desc, desc.channels))
    assert np.array_equal(backend.encode_single(raws[0], desc), blobs[0])
    after = kernels.launch_counts()
    for name in ("replay", "compact", "emit") + (
            ("logfill",) if channels == 3 else ()):
        assert after[name] > before[name]


@pytest.mark.parametrize("channels,lanes", [(3, 1), (3, 16), (4, 8)])
def test_stream_on_card_matches_oracle(cuda, channels, lanes):
    from qoipp_tpu_torch.ops.device_stream import stream_decode, stream_encode

    desc, raws, blobs = make_corpus(1, 320, 200, seed=channels,
                                    channels=channels)
    before = kernels.launch_counts()
    got = stream_encode(raws[0], desc, 1 << 13, lanes)
    assert got == blobs[0].tobytes()
    mid = kernels.launch_counts()
    for name in ("fields", "compact", "emit"):
        assert mid[name] > before[name]
    pixels, dec = stream_decode(blobs[0], 1 << 14, feed=5000)
    assert np.array_equal(pixels, raws[0])
    assert dec.device.type == "cuda" and len(dec.windows) > 1
    after = kernels.launch_counts()
    for name in ("replay_summary", "place_fill"):
        assert after[name] > mid[name]


CORPUS_DIR = Path(__file__).resolve().parent / "resources" / "local_corpus"


def _real_corpus():
    """The committed real corpus: (names, streams, descs, raw pixels)."""
    from qoipp_tpu_torch.common import read_header

    paths = sorted(CORPUS_DIR.glob("*.qoi"))
    blobs = [np.fromfile(p, np.uint8) for p in paths]
    descs = [read_header(b).value() for b in blobs]
    raws = [oracle.decode(b, d, d.channels) for b, d in zip(blobs, descs)]
    return [p.stem for p in paths], blobs, descs, raws


def test_serving_on_card_matches_oracle(cuda):
    """ServingCodec over the real corpus: packed tiers, the split route
    (photo_china_1080p) and the bucketed encode route, every stream equal
    to the oracle's pixels and bytes, the overlapped dispatch and a
    resident corpus too."""
    from qoipp_tpu_torch.models.serving import ServingCodec

    names, blobs, descs, raws = _real_corpus()
    codec = ServingCodec(device=cuda)
    before = kernels.launch_counts()
    n, packed_parts, split_parts = codec.decode_dispatch(blobs)
    assert [names[i] for grp, _ in split_parts for i in grp] == [
        "photo_china_1080p"]
    for got in (codec.decode_finish((n, packed_parts, split_parts)),
                codec.decode_finish(codec.decode_dispatch_overlapped(blobs)),
                codec.make_resident(blobs).decode()):
        for name, g, raw in zip(names, got, raws):
            assert np.array_equal(g, raw), name
    for name, s, raw, d in zip(names, codec.encode(raws, descs), raws, descs):
        assert np.array_equal(s, oracle.encode(raw, d)[0]), name
    after = kernels.launch_counts()
    for kernel in ("replay", "place_fill", "replay_summary", "compact",
                   "emit"):
        assert after[kernel] > before[kernel], kernel


def test_gather_at_serving_corpus_shapes(cuda, monkeypatch):
    """G1 on ServingCodec decode of the committed corpus (a packed tier and
    the split group of photo_china_1080p): one launch a part, each part's
    call equal to the plain version byte for byte over its whole output
    from a sentinel, the decode equal to the oracle, one fetch of exactly
    the bytes returned and gather_px its pixels."""
    from qoipp_tpu_torch.models.serving import ServingCodec
    from qoipp_tpu_torch.ops import gather_kernel
    from qoipp_tpu_torch.utils import tracing

    names, blobs, descs, raws = _real_corpus()
    codec = ServingCodec(device=cuda)
    plan = codec.decode_dispatch(blobs)
    parts = len(plan[1]) + len(plan[2])
    assert len(plan[1]) >= 1 and len(plan[2]) == 1
    calls, real = [], gather_kernel.gather_pixels

    def spy(src, table, out, table_dev=None):
        calls.append((src, table, out.numel()))
        return real(src, table, out, table_dev)

    monkeypatch.setattr(gather_kernel, "gather_pixels", spy)
    before = kernels.launch_counts()["gather_pixels"]
    with tracing.collect() as tr:
        got = codec.decode_finish(plan)
    monkeypatch.undo()  # gather_err below calls the wrapper itself
    assert kernels.launch_counts()["gather_pixels"] == before + parts
    assert len(calls) == parts
    for name, g, raw in zip(names, got, raws):
        assert np.array_equal(g, raw), name
    cnt = {k: v for (_, k), v in tr.counters.items()}
    assert cnt["gather_px"] == sum(d.width * d.height for d in descs)
    assert cnt["d2h_bytes"] == sum(r.nbytes for r in raws)
    assert sum(s.name == "host.fetch" for s in tr.spans) == 1
    for src, table, nbytes in calls:
        before = kernels.launch_counts()["gather_pixels"]
        assert selfcheck.gather_err(src, table, nbytes) == 0
        assert kernels.launch_counts()["gather_pixels"] == before + 1


def test_packed_lanes_on_card_match_oracle(cuda):
    """PackedDecoder and PackedEncoder on lanes that hold several streams
    each (40 tiny streams and the real corpus' icons), equal to the
    oracle; and one stream alone."""
    from qoipp_tpu_torch.models.packed import PackedDecoder, PackedEncoder

    rng = np.random.default_rng(3)
    names, blobs, descs, raws = _real_corpus()
    icons = [i for i, n in enumerate(names) if n.startswith("icon")]
    cases = [(raws[i], descs[i]) for i in icons]
    for k in range(40):
        d = Desc(3 + k % 5, 2 + k % 3, Channels.RGBA if k % 2 else
                 Channels.RGB)
        cases.append((rng.integers(0, 256, d.width * d.height *
                                   int(d.channels), np.uint8), d))
    streams = [oracle.encode(r, d)[0] for r, d in cases]
    dec = PackedDecoder(device=cuda)
    where = dec.plan_and_pack(streams)[3]
    assert max(sum(1 for w in where if w[0] == lane)
               for lane, _ in where) > 1  # lanes of several streams
    for got, (raw, _) in zip(dec.decode(streams), cases):
        assert np.array_equal(got, raw)
    enc = PackedEncoder(device=cuda)
    assert max(k for _, k in enc.plan_and_pack(
        [r for r, _ in cases], [d for _, d in cases])[2]) > 0
    for got, want in zip(enc.encode([r for r, _ in cases],
                                    [d for _, d in cases]), streams):
        assert np.array_equal(got, want)
    assert np.array_equal(enc.encode([cases[0][0]], [cases[0][1]])[0],
                          streams[0])
    assert np.array_equal(dec.decode([streams[0]])[0], cases[0][0])


def test_api_device_backend_on_card(cuda):
    """api's torch backend round trip (K1 and K6 to decode an opaque image,
    K3 and K4 to encode) equal to the native backend, a truncated stream
    included."""
    from qoipp_tpu_torch import api

    for channels in (3, 4):
        desc, raws, blobs = make_corpus(1, 200, 120, seed=channels,
                                        channels=channels)
        before = kernels.launch_counts()
        enc = api.encode(raws[0], desc, backend="torch").value()
        assert np.array_equal(enc, blobs[0])
        for blob in (enc, enc[: enc.size // 2]):
            got = api.decode(blob, backend="torch").value()
            want = api.decode(blob, backend="native").value()
            assert got.desc == want.desc
            assert np.array_equal(got.data, want.data)
        after = kernels.launch_counts()
        for name in ("replay", "compact", "emit") + (
                ("logfill",) if channels == 3 else ()):
            assert after[name] > before[name], name


def test_single_request_engines_on_card(cuda):
    """B = 1 on the card: one stream through the bucketed codec (K1 reads a
    lane-major (qb, 1) view) and one request through the serving codec."""
    from qoipp_tpu_torch.models.scheduler import BucketedCodec
    from qoipp_tpu_torch.models.serving import ServingCodec

    desc, raws, blobs = make_corpus(1, 96, 64, seed=5, channels=4)
    codec = BucketedCodec(desc, min_len=1 << 12, device=cuda)
    assert np.array_equal(codec.decode(blobs)[0].reshape(-1), raws[0])
    assert np.array_equal(codec.encode(raws[0][None])[0], blobs[0])
    serving = ServingCodec(split_min_bytes=1 << 12, device=cuda)
    assert np.array_equal(serving.decode(blobs)[0], raws[0])
    assert np.array_equal(serving.encode(raws, [desc])[0], blobs[0])


def test_bucketed_resident_decode_at_4k(cuda):
    """decode_to_device at its defaults on two 3840 x 2160 RGB frames, the
    photo mosaic first: a 2 x 2 mosaic of photo_china_1080p with flipped
    tiles (~11.3 MB, the 16 MiB bucket: B1, K1 and K2 on a lane of qb
    16,777,216) and a generator frame (the 1 MiB bucket); both frames on
    the card in submission order, equal to their own pixels."""
    from qoipp_tpu_torch.models.scheduler import BucketedCodec

    desc, (flat,), (flat_blob,) = make_corpus(1, 3840, 2160, seed=1)
    data = np.fromfile(CORPUS_DIR / "photo_china_1080p.qoi", np.uint8)
    d = oracle.read_header(data)
    tile = oracle.decode(data, d, d.channels).reshape(d.height, d.width, 3)
    photo = np.concatenate([
        np.concatenate([tile[:, ::-1], tile[::-1]], axis=1),
        np.concatenate([tile[::-1, ::-1], tile], axis=1)]).reshape(-1)
    photo_blob = oracle.encode(photo, desc)[0]
    codec = BucketedCodec(desc, device=cuda)
    out = codec.decode_to_device([photo_blob, flat_blob])
    assert out.device.type == "cuda" and out.shape == (2, 2160, 3840, 3)
    assert sorted(p.qb for p in codec._pipes.values()) == [1 << 20, 1 << 24]
    for got, want in zip(out, (photo, flat)):
        assert torch.equal(got.reshape(-1), torch.from_numpy(want).to(cuda))


def test_pinned_pack_block_not_reused_while_its_copy_runs(cuda):
    """pack_streams' pinned block goes back to the caching host allocator
    when its arrays die, but not to a new pack while the copy that reads
    it waits on the stream: batch A is packed, its decode queued behind a
    ~0.1 s sleep and its arrays dropped; batch B, of other streams, is
    packed into another block at once and decoded. Both decode to their
    own pixels; after a synchronise a third pack takes one of the two
    blocks again."""
    from qoipp_tpu_torch.models.pipeline import BatchPipeline

    desc, raws_a, blobs_a = make_corpus(8, 320, 200, seed=3)
    _, raws_b, blobs_b = make_corpus(8, 320, 200, seed=4)
    pipe = BatchPipeline(desc, max_stream_len=max(
        x.size for x in blobs_a + blobs_b), device=cuda)
    outs, blocks = [], []
    for blobs in (blobs_a, blobs_b):
        streams, sizes = pipe.pack_streams(blobs)
        blocks.append(streams.ctypes.data)
        if not outs:
            torch.cuda._sleep(200_000_000)
        outs.append(pipe.decode(streams, sizes))
        del streams, sizes
    assert blocks[0] != blocks[1]
    torch.cuda.synchronize()
    for out, raws in zip(outs, (raws_a, raws_b)):
        want = torch.from_numpy(np.stack(raws)).to(cuda)
        assert torch.equal(out.reshape(want.shape), want)
    streams, _ = pipe.pack_streams(blobs_a)
    assert streams.ctypes.data in blocks


def test_batch_decode_uploads_from_the_pinned_pack(cuda):
    """A traced batch decode counts the pinned bytes pack_streams wrote,
    uploads exactly them, and makes no pageable upload."""
    from qoipp_tpu_torch.models.pipeline import BatchPipeline
    from qoipp_tpu_torch.utils import tracing

    desc, raws, blobs = make_corpus(4, 320, 200, seed=5)
    pipe = BatchPipeline(desc, max_stream_len=max(x.size for x in blobs),
                         device=cuda)
    with tracing.collect() as tr:
        streams, sizes = pipe.pack_streams(blobs)
        out = pipe.decode(streams, sizes)
    torch.cuda.synchronize()
    c = {k: v for (_, k), v in tr.counters.items()}
    assert streams.base.is_pinned() and sizes.base.is_pinned()
    assert c["pack_pinned_bytes"] == streams.nbytes + sizes.nbytes
    assert c["h2d_bytes"] == streams.nbytes + sizes.nbytes
    assert c.get("h2d_pageable_bytes", 0) == 0
    want = torch.from_numpy(np.stack(raws)).to(cuda)
    assert torch.equal(out.reshape(want.shape), want)


def test_bucketed_decode_of_mixed_lengths_on_card(cuda):
    """decode_to_device over buckets of flat frames and photo crops
    (five flat frames take six lanes: a header-only padding lane), each
    bucket packed into a pinned block and uploaded from it, equals
    decode (fetched) and the oracle, in submission order."""
    from qoipp_tpu_torch.models.scheduler import BucketedCodec
    from qoipp_tpu_torch.utils import tracing

    w, h = 96, 54
    desc, flats, _ = make_corpus(5, w, h, seed=7)
    data = np.fromfile(CORPUS_DIR / "photo_china_1080p.qoi", np.uint8)
    d = oracle.read_header(data)
    photo = oracle.decode(data, d, d.channels).reshape(d.height, d.width, 3)
    crops = [np.ascontiguousarray(photo[y: y + h, x: x + w]).reshape(-1)
             for y, x in ((400, 800), (600, 200), (800, 600))]
    raws = [flats[0], crops[0], *flats[1:3], crops[1], *flats[3:], crops[2]]
    blobs = [oracle.encode(r, desc)[0] for r in raws]
    codec = BucketedCodec(desc, min_len=1 << 11, device=cuda)
    with tracing.collect() as tr:
        out = codec.decode_to_device(blobs)
    torch.cuda.synchronize()
    c = {k: v for (_, k), v in tr.counters.items()}
    assert len(codec._pipes) == 2 and c["bucket_lanes"] == 6 + 3
    assert c["pack_pinned_bytes"] == c["h2d_bytes"]
    assert c.get("h2d_pageable_bytes", 0) == 0
    host = codec.decode(blobs)
    assert np.array_equal(out.cpu().numpy(), host)
    for i, raw in enumerate(raws):
        assert np.array_equal(host[i].reshape(-1), raw), i
        assert np.array_equal(raw, oracle.decode(blobs[i], desc,
                                                 desc.channels)), i


@pytest.mark.parametrize("module,name,argv", [
    ("expt_place_wide", "place_wide", ["-b", "2", "--rows", "40000"]),
    ("expt_place2", "place_fill2", ["-b", "3", "--rows", "8192"]),
    ("expt_place_narrow", "place_fill_narrow", ["-b", "2", "--rows", "40000"]),
    ("expt_place_fixed", "place_variant", ["-b", "2", "--rows", "40960"]),
])
def test_place_window_experiment_on_card(cuda, module, name, argv):
    import importlib

    expt = importlib.import_module(f"qoipp_tpu_torch.benchmarks.{module}")
    before = kernels.launch_counts()[name]
    rows = expt.main(argv + ["--runs", "2"], device=cuda)
    assert all(r["max_abs_err"] == 0 and r["ms"] > 0 for r in rows)
    assert any(r["k2_err"] == 0 for r in rows)
    assert kernels.launch_counts()[name] > before


def test_grouped_and_emit_experiments_on_card(cuda):
    from qoipp_tpu_torch.benchmarks import expt_emit_wide, expt_place

    before = kernels.launch_counts()
    rows = expt_place.main(["-b", "4", "--cap", "24576", "--n-cap",
                            str(24 * 8192), "--runs", "2"], device=cuda)
    assert [r["max_abs_err"] for r in rows] == [None, 0]
    assert rows[1]["k2_err"] == 0 and all(r["ms"] > 0 for r in rows)
    rows = expt_emit_wide.main(["-b", "2", "--rows", "20000", "--runs", "2"],
                               device=cuda)
    assert all(r["max_abs_err"] == 0 and r["k4_err"] == 0 for r in rows)
    after = kernels.launch_counts()
    for name in ("place_grouped", "emit_window"):
        assert after[name] > before[name]


def test_profile_r2_probes_on_card(cuda):
    from qoipp_tpu_torch.benchmarks import profile_r2

    before = kernels.launch_counts()
    out = profile_r2.main(["--batch", "2", "--width", "320", "--height",
                           "200", "--steps", "64", "4096", "--blocks", "256",
                           "--runs", "2"], device=cuda)
    assert all(r["max_abs_err"] == 0 and r["ms"] > 0
               for r in out["grid_step"])
    assert out["onehot_place"]["max_abs_err"] <= 1e-6
    assert out["stage_ms"]["decode_packed"] > 0
    after = kernels.launch_counts()
    for name in ("grid_step", "onehot_place"):
        assert after[name] > before[name]


def test_wrapper_rejects_bad_input(cuda):
    from qoipp_tpu_torch.ops import place_kernel

    pb = torch.zeros((2, 128), dtype=torch.int64, device=cuda)
    emits = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        place_kernel.place_fill(pb, emits, 8192)
    with pytest.raises(ValueError, match="contiguous"):
        place_kernel.place_fill(pb.to(torch.int32).T.contiguous().T, emits,
                                8192)
    with pytest.raises(ValueError, match="multiple"):
        place_kernel.place_fill(pb.to(torch.int32), emits, 8000)
    from qoipp_tpu_torch.ops import compact_kernel

    keep = torch.ones((2, 128), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="planes"):
        compact_kernel.compact_rows((emits,) * 5, keep, 128)
    with pytest.raises(ValueError, match="dtype"):
        compact_kernel.compact_rows((emits,), keep.to(torch.uint8), 128)


def test_dep_chain_matches_plain_version(cuda):
    from qoipp_tpu_torch.benchmarks import replay_probe
    from qoipp_tpu_torch.ops import probes

    before = kernels.launch_counts()["dep_chain"]
    cycles, ns, x = probes.dep_chain(cuda, 3)
    assert x == probes.dep_chain_reference(3)
    assert cycles > 0 and ns >= 0
    assert kernels.launch_counts()["dep_chain"] == before + 1
    lat, mhz = replay_probe.chain_latency(cuda)
    assert 1 <= lat < 64 and 100 < mhz < 5000


def test_parallel_jobs_on_card_match_oracle(cuda, tmp_path):
    """tests/test_torch_parallel.py's world-4 cases with every rank on the
    card; each rank launched the kernels of its paths."""
    import torch_parallel_jobs as jobs

    job = jobs.run_job(tmp_path, jobs.inputs4, jobs.world4, 4, "cuda", 600)
    jobs.check_dp_decode(job, "dp")
    jobs.check_dp_encode(job)
    for r in job["ranks"]:
        assert jobs.overflow_images(r["dp_overflow"]) == jobs.OVERFLOW_IMAGES
    for name in ("sp", "adv"):
        _, _, rounds = jobs.check_sp_decode(job, name)
        assert len(set(rounds)) == 1 and rounds[0] <= 4 * jobs.SP_TILES + 2
    for name in ("enc_rgb", "enc_rgba"):
        jobs.check_sp_encode(job, name, [0, 1, 2, 3])
    for counts in job["counts"]:
        for name in ("replay", "place_fill", "compact", "emit",
                     "replay_summary", "fields"):
            assert counts[name] > 0, name


def test_dryrun_multichip_on_card(cuda):
    from qoipp_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, timeout=600)
    assert len({o["checksum"] for o in out}) == 1


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_bytes_on_card_matches_cpu(cuda, channels):
    from qoipp_tpu_torch.ops import boundary
    from qoipp_tpu_torch.ops import decode as dec_ops

    desc, raws, blobs = make_corpus(1, 200, 120, seed=5, channels=channels)
    blob = blobs[0]
    n_px = desc.width * desc.height
    qb = dec_ops._bucket(blob.size - 14, boundary.BLOCK)
    region = np.zeros(qb + 8, np.uint8)
    region[: blob.size - 14] = blob[14:]
    s_tiles, n_cap = dec_ops.pick_tiles(qb), dec_ops._bucket(n_px, 128)
    out = []
    for dev in (cuda, torch.device("cpu")):
        reg = torch.from_numpy(region).to(dev)
        info = boundary.analyze_region(reg[:qb], blob.size - 22, n_px)
        before = kernels.launch_counts()["replay_summary"]
        packed, filled = dec_ops.decode_bytes(
            reg, info["real"], info["produced"], info["pix_before"], n_px,
            s_tiles, n_cap)
        assert (kernels.launch_counts()["replay_summary"] > before) == (
            dev.type == "cuda")
        out.append((packed.cpu(), int(filled)))
    assert torch.equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]
    got = out[0][0][:n_px].numpy().view(np.uint8).reshape(n_px, 4)
    want = oracle.decode(blob, desc, Channels.RGBA).reshape(n_px, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("target", sorted(fuzz.FUZZERS))
def test_fuzz_target_on_card(cuda, target):
    """Three rounds of each fuzz target on the card (seed 0), every result
    against the oracle; the device targets launch kernels."""
    before = sum(kernels.launch_counts().values())
    fuzz.run(3, 0, only=target, device=cuda)
    torch.cuda.synchronize()
    assert (sum(kernels.launch_counts().values()) > before) == (
        target != "stream")


def test_ingest_example_on_card(cuda, capsys):
    """The ingest example at B=2: decoded pixels equal the oracle's and
    the bf16 features agree with fp32 (the example raises otherwise)."""
    from qoipp_tpu_torch.examples import ingest_pipeline

    before = kernels.launch_counts()
    assert ingest_pipeline.main(["--batch", "2", "--size", "64",
                                 "--runs", "2"]) == 0
    after = kernels.launch_counts()
    assert after["replay"] > before["replay"]
    assert after["place_fill"] > before["place_fill"]
    assert "device time on" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    ("tools.fuzz", ["-n", "1"]),
    ("tools.bench", ["--synthetic", "1", "--width", "64", "--height", "48"]),
    ("tools.bench", ["--sizes", "64x48"]),
    ("examples.ingest_pipeline", ["--batch", "1", "--size", "64"]),
    ("examples.serving_codec", []),
])
def test_tools_refuse_cuda_without_card(cuda, monkeypatch, tool, argv):
    """Asked for the card (their default) where torch sees none, the tools
    raise; they never go on on the CPU."""
    import importlib

    mod = importlib.import_module(f"qoipp_tpu_torch.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert kernels.launch_counts() == before


def _noise_items(seed, n=8):
    """n noise images, 40 + 8k x 30, RGB and RGBA: (raw, desc, blob)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        d = Desc(40 + 8 * k, 30, Channels.RGB if k % 2 else Channels.RGBA)
        raw = rng.integers(0, 256, d.width * d.height * int(d.channels),
                           np.uint8)
        out.append((raw, d, oracle.encode(raw, d)[0]))
    return out


def _staging_engines():
    """name -> (module whose stage_h2d the engine calls, run(corpus, dev)
    -> (outputs, the oracle's))."""
    from qoipp_tpu_torch.models import packed, serving, split
    from qoipp_tpu_torch.ops import device_stream

    def split_run(c, dev):
        dec = split.SplitDecoder(lanes=8, device=dev)
        return ([dec.gather(*dec.decode_to_device([b])[:3])[0]
                 for _, _, b in c[:2]], [r for r, _, _ in c[:2]])

    def overlapped(c, dev):
        codec = serving.ServingCodec(pack_lane_bytes=8 << 10,
                                     min_len=1 << 12, device=dev)
        return (codec.decode_finish(codec.decode_dispatch_overlapped(
            [b for _, _, b in c])), [r for r, _, _ in c])

    def bucket(c, dev):
        c = c[5:] * 2  # past pack_lane_px: two images a geometry bucket
        return (serving.ServingCodec(pack_lane_px=64, min_len=1 << 12,
                                     device=dev).encode(
            [r for r, _, _ in c], [d for _, d, _ in c]),
            [b for _, _, b in c])

    return {
        "split": (split, split_run),
        "packed decode": (packed, lambda c, dev: (packed.PackedDecoder(
            lane_bytes=16 << 10, device=dev).decode([b for _, _, b in c]),
            [r for r, _, _ in c])),
        "packed encode": (packed, lambda c, dev: (packed.PackedEncoder(
            lane_px=4096, device=dev).encode([r for r, _, _ in c],
                                             [d for _, d, _ in c]),
            [b for _, _, b in c])),
        "serving bucket": (serving, bucket),
        "serving overlapped (side stream)": (packed, overlapped),
        "device stream": (device_stream, lambda c, dev: (
            [device_stream.stream_decode(b, 2048, device=dev)[0]
             for _, _, b in c[:2]], [r for r, _, _ in c[:2]])),
    }


@pytest.mark.parametrize("engine", [
    "split", "packed decode", "packed encode", "serving bucket",
    "serving overlapped (side stream)", "device stream"])
def test_chunked_staging_on_card(cuda, monkeypatch, engine):
    """Each engine's staged upload at 256-byte chunks on the card (pinned
    pieces into one device tensor): equal to its unchunked run and the
    oracle, at least one upload cut into pieces; the overlapped serving
    dispatch stages on a side stream."""
    from qoipp_tpu_torch.utils import transport

    module, run = _staging_engines()[engine]
    corpus = _noise_items(5)
    want, ref = run(corpus, cuda)
    calls = dict(staged=0, one_shot=0)
    real_stage, real_upload = module.stage_h2d, transport.upload

    def stage(*a, **k):
        calls["staged"] += 1
        return real_stage(*a, **k)

    def upload(*a, **k):
        calls["one_shot"] += 1
        return real_upload(*a, **k)

    monkeypatch.setattr(module, "stage_h2d", stage)
    monkeypatch.setattr(transport, "upload", upload)
    transport.set_h2d_chunk_bytes(256)
    try:
        got, _ = run(corpus, cuda)
    finally:
        transport.set_h2d_chunk_bytes(0)
    assert calls["staged"] > calls["one_shot"]
    assert len(got) == len(want) == len(ref)
    for a, b, c in zip(want, got, ref):
        assert np.array_equal(a, b) and np.array_equal(b, c)


def test_stage_h2d_on_card(cuda):
    from qoipp_tpu_torch.utils import transport

    host = np.random.default_rng(2).integers(0, 256, (1000, 96), np.uint8)
    transport.set_h2d_chunk_bytes(4096)
    try:
        got = transport.stage_h2d(host, cuda)
    finally:
        transport.set_h2d_chunk_bytes(0)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), host)


@pytest.mark.parametrize("b,qb", [(2, 128), (3, 512), (2, 37 * 128),
                                  (8, 2048 * 128)])
def test_two_level_boundary_scan_on_card(cuda, b, qb):
    from qoipp_tpu_torch.benchmarks import expt_boundary2l
    from qoipp_tpu_torch.ops import boundary

    reg = torch.from_numpy(expt_boundary2l._rand_streams(
        np.random.default_rng(qb), min(b, 2), qb)).to(cuda).repeat(b, 1)[:b]
    assert torch.equal(expt_boundary2l.chunk_starts_batch_2l(reg),
                       boundary.chunk_starts_batch(reg))


# (B, Qb) of the chunk-start scan on the two-level experiment's byte soup:
# one block to batch1080_decode's 128 x 2,176 blocks
SCAN_SOUP_SHAPES = [(1, 128), (3, 512), (2, 37 * 128), (8, 2048 * 128),
                    (128, 2176 * 128)]


def _soup(b, qb, cuda):
    """b rows of the experiment's byte soup on the card (up to 4 drawn,
    repeated)."""
    from qoipp_tpu_torch.benchmarks import expt_boundary2l

    rows = torch.from_numpy(expt_boundary2l._rand_streams(
        np.random.default_rng(qb), min(b, 4), qb)).to(cuda)
    return rows.repeat(-(-b // rows.shape[0]), 1)[:b]


def _scan_once(regions):
    """The chunk-start scan's kernel on regions, one launch, bit-exact to
    its plain version."""
    from qoipp_tpu_torch.ops import boundary

    before = kernels.launch_counts()["chunk_starts"]
    got = boundary.chunk_starts_batch(regions)
    assert kernels.launch_counts()["chunk_starts"] == before + 1
    assert got.dtype == torch.bool and got.shape == regions.shape
    assert torch.equal(got, boundary.chunk_starts_batch_plain(regions))


@pytest.mark.parametrize("b,qb", SCAN_SOUP_SHAPES)
def test_chunk_starts_kernel_on_byte_soup(cuda, b, qb):
    _scan_once(_soup(b, qb, cuda))


@pytest.mark.parametrize("qseg", [12288, 14336, 16384])
def test_chunk_starts_kernel_on_window_plane_view(cuda, qseg):
    """The stream window's (96, qseg + 8) plane read through its [:, :qseg]
    view, no copy: rows alternately 16- and 8-byte aligned."""
    plane = torch.zeros((96, qseg + 8), dtype=torch.uint8, device=cuda)
    plane[:, :qseg] = _soup(96, qseg, cuda)
    view = plane[:, :qseg]
    assert view.stride() == (qseg + 8, 1)
    _scan_once(view)


def test_chunk_starts_kernel_on_a_planned_window(cuda):
    """The streaming decoder's own plan of a 1 MiB window of the committed
    1080p photo (stream8k_decode's tile: 96 lanes, qseg as plan_window
    buckets it), read as _decode_window_lanes reads it."""
    from qoipp_tpu_torch.ops import device_stream

    blob = np.fromfile(CORPUS_DIR / "photo_china_1080p.qoi", np.uint8)
    assert blob.size > 14 + (1 << 20)
    dec = device_stream.DeviceStreamDecoder(device=cuda)
    dec.initialize(blob[:14]).value()
    plane, _, _, qseg, *_ = dec.plan_window(blob[14: 14 + (1 << 20)].tobytes())
    assert plane.shape == (96, qseg + 8)
    _scan_once(torch.from_numpy(plane).to(cuda)[:, :qseg])


@pytest.mark.parametrize("tag", [0x00, 0x80, 0xFE, 0xFF])
def test_chunk_starts_kernel_on_one_tag_rows(cuda, tag):
    """Rows of one tag: every byte a start (1-byte ops), and LUMA, RGB and
    RGBA chains across 40 tiles, each tile's entry phase from its look-back."""
    _scan_once(torch.full((3, 40 * 4096 + 128), tag, dtype=torch.uint8,
                          device=cuda))


def test_chunk_starts_kernel_on_corpus_regions(cuda):
    """Real make_corpus streams' regions, RGB and RGBA, as the batch
    pipeline cuts them."""
    from qoipp_tpu_torch.models.pipeline import BatchPipeline

    for ch, seed in ((3, 1), (4, 2)):
        desc, _, blobs = make_corpus(4, 320, 200, seed=seed, channels=ch)
        pipe = BatchPipeline(desc, max_stream_len=max(x.size for x in blobs),
                             device=cuda)
        streams, sizes = (torch.from_numpy(x).to(cuda)
                          for x in pipe.pack_streams(blobs))
        q = torch.arange(pipe.qb, device=cuda)[None, :]
        _scan_once(torch.where(q < (sizes - 14)[:, None],
                               streams[:, 14: 14 + pipe.qb], 0).contiguous())


def test_chunk_starts_device_ops_do_not_grow_with_shape(cuda):
    """A call is the kernel and its status words' fill, one row or 128 rows
    of batch1080_decode's width."""
    from qoipp_tpu_torch.ops import boundary
    from qoipp_tpu_torch.utils import profile

    for b, qb in ((1, 128), (128, 2176 * 128)):
        reg = torch.zeros((b, qb), dtype=torch.uint8, device=cuda)
        groups = profile.profile_path(
            lambda: boundary.chunk_starts_batch(reg), calls=5,
            warmup=1)["groups"]
        assert groups["boundary scan"][1] > 0
        assert sum(n for _, n in groups.values()) <= 3


def test_boundary_scan_counters_on_card(cuda):
    """boundary_scans and boundary_scan_bytes count the kernel's launches
    and the region bytes they read: one over B x qb in a traced batch
    decode, one a window over its (L, qseg) in a stream session."""
    from qoipp_tpu_torch.models.pipeline import BatchPipeline
    from qoipp_tpu_torch.ops import device_stream
    from qoipp_tpu_torch.utils import tracing

    def counted(fn):
        before = kernels.launch_counts()["chunk_starts"]
        with tracing.collect() as tr:
            fn()
        c = {}
        for (_, k), v in tr.counters.items():
            c[k] = c.get(k, 0) + v
        return kernels.launch_counts()["chunk_starts"] - before, c

    desc, _, blobs = make_corpus(4, 320, 200, seed=5)
    pipe = BatchPipeline(desc, max_stream_len=max(x.size for x in blobs),
                         device=cuda)
    streams, sizes = (torch.from_numpy(x).to(cuda)
                      for x in pipe.pack_streams(blobs))
    launched, c = counted(lambda: pipe.decode_packed(streams, sizes))
    assert launched == c["boundary_scans"] == 1
    assert c["boundary_scan_bytes"] == len(blobs) * pipe.qb

    side = 512
    blob, _ = oracle.encode(make_image(side, side, seed=3),
                            Desc(side, side, Channels.RGB))
    out = {}
    launched, c = counted(lambda: out.update(zip(
        ("px", "dec"), device_stream.stream_decode(blob, 1 << 16,
                                                   device=cuda))))
    windows = out["dec"].windows
    assert len(windows) > 1
    assert launched == c["boundary_scans"] == len(windows)
    assert c["boundary_scan_bytes"] == sum(
        -(-w["lanes"] // 8) * 8 * w["qb"] for w in windows)


@pytest.fixture
def small_corpus(tmp_path):
    for i, (ch, w, h) in enumerate([(3, 48, 40), (4, 48, 40), (3, 64, 48),
                                    (4, 80, 40)]):
        for j, blob in enumerate(make_corpus(2, w, h, seed=i,
                                             channels=ch)[2]):
            (tmp_path / f"img{i}_{j}.qoi").write_bytes(blob.tobytes())
    return str(tmp_path)


@pytest.mark.parametrize("module,argv", [
    ("profile_r3", ["--batch", "4", "--encode-batch", "2", "--width",
                    "320", "--height", "200"]),
    ("profile_bucket_decode", ["--cap-kb", "0", "--corpus", "{}"]),
    ("profile_packed_decode", ["--lane-kb", "64", "--corpus", "{}"]),
    ("profile_packed_encode", ["--lane-px", "4096", "--corpus", "{}"]),
    ("expt_boundary2l", ["--batch", "8", "--qb", "65536"]),
    ("expt_table_stack", []),
    ("expt_compact", ["--lanes", "2", "--rows", "65536", "--cap", "40960"]),
    ("expt_enc_lanes", ["--lanes", "2", "4", "--lane-px", "4096",
                        "--corpus", "{}"]),
    ("expt_h2d_chunks", ["--mb", "4", "--pieces", "1", "4", "64"]),
])
def test_profile_script_on_card(cuda, small_corpus, module, argv):
    """Each stage profile and experiment at a small size on the card, timed
    (--runs 2): its holds pass and it returns times."""
    import importlib

    mod = importlib.import_module(f"qoipp_tpu_torch.benchmarks.{module}")
    out = mod.main([a.format(small_corpus) for a in argv] + ["--runs", "2"],
                   device=cuda)
    assert out
