"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version (the edge cases of qoipp_tpu_torch.kernels.selfcheck, as
chip_smoke.py's phase 2), and the batch pipeline, the split decoder, the
one-shot codec and the streaming codec at a small size against the port's
oracle, K2 and E1 across many blocks (selfcheck.place_fill_cases and
fields_segments), E3 on selfcheck.FILL2_CASES, E4 at every
selfcheck.GROUPED_SHAPES, E5 on selfcheck.narrow_case at every ns the
selfcheck takes and E6's instantiations on selfcheck.reach_case at every
n_fill, and the experiment scripts (E2-E7, and E8/E9 in
profile_r2) at a small size; and K1 and K5 against their plain versions
on the whole output over no rows and tile-edge row counts, lane counts,
both row layouts and one-class, reset, random and palette rows; K3 and K6
on their edge cases (selfcheck.COMPACT_CASES, LOGFILL_CASES), K3 twice in
a row, without a torch scan and refusing short status words; and the
latency probe behind the replay chain bound against its plain loop.
Without a CUDA device every test here skips.

Run on a GPU machine (tests/conftest.py imports JAX, which it lacks):

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q"""

import numpy as np
import pytest
import torch

from qoipp_tpu_torch import kernels, oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.ops.bitops import hash6
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


@pytest.mark.parametrize("name", ["place_fill_narrow", "place_variant"])
def test_place_window_launch_shapes(cuda, name):
    from qoipp_tpu_torch.ops import place_window

    threads, per_sm = place_window.launch_shape(name)
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
