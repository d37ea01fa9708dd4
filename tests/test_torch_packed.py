"""The port's packed lanes (qoipp_tpu_torch.models.packed, and the lane
encoder of ops/encode.py) against qoipp_tpu's and the native oracle,
bit-exact (tolerance: exact equality everywhere): every case of
test_packed.py and test_packed_encode.py run through the port on the CPU
(each kernel's plain version), the lane plans of both planners, the whole
(l_total, n_cap) output of _decode_lanes, encode_lanes_checked's outputs,
the segmented same-hash predecessor, one-stream lanes and the start-hash
seeding at a stream reset inside a lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.common import Channels as JChannels
from qoipp_tpu.common import Desc as JDesc
from qoipp_tpu.models import packed as jpacked
from qoipp_tpu.ops import encode as jenc
from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc, write_header
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.models import packed
from qoipp_tpu_torch.models.packed import (PackedDecoder, PackedEncoder,
                                           plan_lanes)
from qoipp_tpu_torch.ops import encode as enc_ops
from qoipp_tpu_torch.ops.bitops import hash6

torch.set_num_threads(1)


def _jdesc(d):
    return JDesc(d.width, d.height, JChannels(int(d.channels)))


# -- the cases of test_packed.py ----------------------------------------


def corpus():
    """test_packed.py's corpus: mixed geometries and channels, crafted
    openers (an INDEX first chunk, a RUN first chunk)."""
    rng = np.random.default_rng(11)
    out = []
    specs = [
        (Desc(31, 7, Channels.RGB), "noise"),
        (Desc(64, 64, Channels.RGBA), "palette"),
        (Desc(16, 16, Channels.RGBA), "zero_first"),
        (Desc(40, 3, Channels.RGB), "run_first"),
        (Desc(128, 90, Channels.RGB), "gradient"),
        (Desc(8, 8, Channels.RGBA), "alpha"),
        (Desc(300, 200, Channels.RGB), "noise"),
        (Desc(5, 5, Channels.RGB), "flat"),
    ]
    for desc, kind in specs:
        n = desc.width * desc.height
        ch = int(desc.channels)
        if kind == "noise":
            raw = rng.integers(0, 256, n * ch, np.uint8)
        elif kind == "palette":
            pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
            raw = pal[rng.integers(0, 6, n)].reshape(-1)
        elif kind == "zero_first":
            px = rng.integers(0, 256, (n, 4), np.uint8)
            px[0] = 0  # (0,0,0,0) hits the encoder's zero slot: INDEX first
            raw = px.reshape(-1)
        elif kind == "run_first":
            px = np.zeros((n, ch), np.uint8)  # the start pixel: RUN first
            px[n // 2:] = rng.integers(0, 256, (n - n // 2, ch))
            raw = px.reshape(-1)
        elif kind == "gradient":
            x = np.arange(n) % desc.width
            raw = np.stack([(x // 2) % 256] * ch, 1).astype(np.uint8)
            raw = raw.reshape(-1)
        elif kind == "alpha":
            raw = rng.integers(0, 256, (n, 4), np.uint8).reshape(-1)
        else:
            raw = np.full(n * ch, 9, np.uint8)
        enc, complete = oracle.encode(raw, desc)
        assert complete
        out.append((raw, desc, enc))
    return out


def _tiny_streams(count, seed=3):
    rng = np.random.default_rng(seed)
    data = []
    for k in range(count):
        desc = Desc(3 + k % 5, 2 + k % 3,
                    Channels.RGBA if k % 2 else Channels.RGB)
        n = desc.width * desc.height
        raw = rng.integers(0, 256, n * int(desc.channels), np.uint8)
        enc, _ = oracle.encode(raw, desc)
        data.append((raw, desc, enc))
    return data


def test_plan_lanes_packs_and_fits():
    items = [(700, 10), (300, 5), (600, 8), (100, 2), (400, 6)]
    lanes = plan_lanes(items, 1000)
    assert sorted(i for L in lanes for i in L) == list(range(5))
    for L in lanes:
        assert sum(items[i][0] for i in L) <= 1000
    assert lanes == jpacked.plan_lanes(items, 1000)


def test_packed_decode_mixed_streams_bit_exact():
    data = corpus()
    got = PackedDecoder(lane_bytes=1 << 19, device="cpu").decode(
        [enc for _, _, enc in data])
    for i, (raw, desc, _) in enumerate(data):
        assert np.array_equal(got[i], raw), f"stream {i} ({desc})"


def test_packed_decode_rejects_truncated_stream():
    good, _ = oracle.encode(np.full(12, 7, np.uint8), Desc(2, 2, Channels.RGB))
    truncated = np.frombuffer(
        write_header(Desc(2, 2, Channels.RGB)) + b"\x00" * 8, np.uint8)
    with pytest.raises(ValueError, match="truncated"):
        PackedDecoder(device="cpu").decode([good, truncated])


def test_packed_decode_lane_count_buckets_to_8():
    rng = np.random.default_rng(5)
    desc = Desc(64, 64, Channels.RGB)
    blobs = [oracle.encode(rng.integers(0, 256, 64 * 64 * 3, np.uint8),
                           desc)[0] for _ in range(9)]
    regions, *_ = PackedDecoder(lane_bytes=1 << 19,
                                device="cpu").plan_and_pack(blobs)
    assert regions.shape[0] % 8 == 0


def test_packed_decode_many_tiny_streams_one_lane():
    data = _tiny_streams(40)
    got = PackedDecoder(lane_bytes=1 << 14, device="cpu").decode(
        [e for _, _, e in data])
    for i, (raw, _, _) in enumerate(data):
        assert np.array_equal(got[i], raw), f"stream {i}"


# -- the cases of test_packed_encode.py ----------------------------------


def _check(cases, lane_px=4096):
    got = PackedEncoder(lane_px=lane_px, device="cpu").encode(
        [r for r, _ in cases], [d for _, d in cases])
    for i, (raw, desc) in enumerate(cases):
        ref, complete = oracle.encode(raw, desc)
        assert complete
        assert got[i].size == ref.size, f"case {i}: length"
        assert (got[i] == ref).all(), f"case {i}: byte mismatch"


def test_mixed_corpus_parity():
    rng = np.random.default_rng(7)
    cases = []
    for k in range(20):
        w, h = 5 + 7 * (k % 5), 3 + k % 4
        ch = Channels.RGBA if k % 3 else Channels.RGB
        n = w * h * int(ch)
        kind = k % 4
        if kind == 0:
            raw = rng.integers(0, 256, n, np.uint8)
        elif kind == 1:  # palette: INDEX-heavy
            pal = rng.integers(0, 256, (5, int(ch)), np.uint8)
            raw = pal[rng.integers(0, 5, w * h)].reshape(-1)
        elif kind == 2:  # flat: RUN-heavy
            raw = np.full(n, (k * 37) % 256, np.uint8)
        else:  # gradient: DIFF/LUMA
            x = (np.arange(w * h) // 3) % 256
            raw = np.stack([x] * int(ch), 1).astype(np.uint8).reshape(-1)
        cases.append((raw, Desc(w, h, ch)))
    _check(cases)


def test_seam_prev_pixel_reset():
    a_last = np.array([9, 8, 7], np.uint8)
    raw_a = np.concatenate([np.array([1, 2, 3] * 3, np.uint8), a_last])
    raw_b = np.concatenate([a_last, np.array([5, 5, 5, 6, 6, 6], np.uint8)])
    _check([(raw_a, Desc(4, 1, Channels.RGB)),
            (raw_b, Desc(3, 1, Channels.RGB))])


def test_seam_table_reset():
    rng = np.random.default_rng(3)
    pal = rng.integers(1, 256, (4, 3), np.uint8)
    d = Desc(30, 2, Channels.RGB)
    raw = pal[rng.integers(0, 4, 60)].reshape(-1)
    _check([(raw.copy(), d), (raw.copy(), d), (raw.copy(), d)])


def test_seam_zero_pixel_fresh_table():
    # (64,0,0,0) hashes to slot 0 in stream A; B's (0,0,0,0) must still hit
    # its fresh table's zero slot
    raw_a = np.array([64, 0, 0, 0, 1, 2, 3, 4], np.uint8)
    raw_b = np.array([0, 0, 0, 0, 7, 7, 7, 7, 1, 1, 1, 1], np.uint8)
    _check([(raw_a, Desc(2, 1, Channels.RGBA)),
            (raw_b, Desc(3, 1, Channels.RGBA))])


def test_run_lengths_and_flushes():
    cases = []
    for n in (1, 2, 61, 62, 63, 124, 125, 200):
        cases.append((np.zeros(3 * n, np.uint8), Desc(n, 1, Channels.RGB)))
        raw = np.zeros((2 * n, 3), np.uint8)
        raw[:n] = [3, 1, 4]
        cases.append((raw.reshape(-1).copy(), Desc(n, 2, Channels.RGB)))
    _check(cases)


def test_single_pixel_streams():
    cases = [(np.array(px, np.uint8), Desc(1, 1, Channels.RGB))
             for px in ([0, 0, 0], [1, 2, 3], [255, 255, 255])]
    cases.append((np.array([0, 0, 0, 255], np.uint8),
                  Desc(1, 1, Channels.RGBA)))
    cases.append((np.array([0, 0, 0, 0], np.uint8),
                  Desc(1, 1, Channels.RGBA)))
    _check(cases)


def test_alpha_seams():
    raw_a = np.array([10, 20, 30, 7, 10, 20, 30, 7, 1, 1, 1, 7], np.uint8)
    raw_b = np.array([9, 9, 9, 255, 2, 2, 2, 9], np.uint8)
    _check([(raw_a, Desc(3, 1, Channels.RGBA)),
            (raw_b, Desc(2, 1, Channels.RGBA))])


def test_many_streams_multi_lane():
    rng = np.random.default_rng(17)
    cases = []
    for k in range(60):
        ch = Channels.RGBA if k % 2 else Channels.RGB
        w, h = 4 + k % 9, 2 + k % 5
        cases.append((rng.integers(0, 256, w * h * int(ch), np.uint8),
                      Desc(w, h, ch)))
    _check(cases, lane_px=2048)


def test_oversized_stream_raises():
    enc = PackedEncoder(lane_px=2048, device="cpu")
    with pytest.raises(ValueError, match="lane capacity"):
        enc.encode([np.zeros(64 * 64 * 3, np.uint8)],
                   [Desc(64, 64, Channels.RGB)])


def _random_cases(rng):
    cases = []
    for _ in range(rng.integers(3, 12)):
        ch = Channels.RGBA if rng.integers(0, 2) else Channels.RGB
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 12))
        n = w * h
        style = rng.integers(0, 4)
        if style == 0:
            raw = rng.integers(0, 256, n * int(ch), np.uint8)
        elif style == 1:
            pal = rng.integers(0, 256, (3, int(ch)), np.uint8)
            raw = pal[rng.integers(0, 3, n)].reshape(-1)
        elif style == 2:
            raw = np.zeros(n * int(ch), np.uint8)
        else:
            raw = np.tile(rng.integers(0, 256, int(ch), np.uint8), n)
            mut = rng.integers(0, raw.size, max(1, n // 8))
            raw[mut] = rng.integers(0, 256, mut.size)
        cases.append((raw, Desc(w, h, ch)))
    return cases


def test_randomized_differential():
    rng = np.random.default_rng(23)
    for _ in range(4):
        _check(_random_cases(rng))


# -- plans, lanes and kernels' inputs against the JAX package -------------


def _plan_corpora():
    data = corpus()
    tiny = _tiny_streams(40)
    return {"mixed": ([e for _, _, e in data], 1 << 19),
            "tiny": ([e for _, _, e in tiny], 1 << 14)}


@pytest.mark.parametrize("name", ["mixed", "tiny"])
def test_decode_plan_and_lanes_match_jax(name):
    """plan_and_pack's regions, seg, chunks_sizes, where, descs, qb, n_cap
    and l_total."""
    blobs, lane_bytes = _plan_corpora()[name]
    plan = PackedDecoder(lane_bytes=lane_bytes,
                         device="cpu").plan_and_pack(blobs)
    want = jpacked.PackedDecoder(lane_bytes=lane_bytes).plan_and_pack(blobs)
    regions, seg, chunks_sizes, where, descs, qb, n_cap, l_total = plan
    jregions, jseg, jchunks, jwhere, jdescs, jqb, jn_cap, jl_total = want
    assert np.array_equal(regions, jregions)
    assert np.array_equal(seg, jseg) and np.array_equal(chunks_sizes, jchunks)
    assert where == jwhere and (qb, n_cap, l_total) == (jqb, jn_cap, jl_total)
    assert [(d.width, d.height, int(d.channels)) for d in descs] == [
        (d.width, d.height, int(d.channels)) for d in jdescs]


def test_decode_lanes_whole_output_matches_jax():
    """_decode_lanes' whole (l_total, n_cap) output, past each lane's
    pixels too, through stage_plan and dispatch_staged (the mixed
    corpus' 180 KB stream is held by the oracle above)."""
    blobs, lane_bytes = _plan_corpora()["tiny"]
    dec = PackedDecoder(lane_bytes=lane_bytes, device="cpu")
    regions, seg, chunks_sizes, _, _, qb, n_cap, l_total = dec.plan_and_pack(
        blobs)
    got = words_to_numpy(dec.dispatch_staged(dec.stage_plan(
        dec.plan_and_pack(blobs)))[0])
    ref = np.asarray(jpacked._decode_lanes(
        jnp.asarray(regions), jnp.asarray(seg), jnp.asarray(chunks_sizes),
        qb=qb, n_cap=n_cap, l_total=l_total))
    assert got.shape == ref.shape == (l_total, n_cap)
    assert np.array_equal(got, ref)


def _encode_cases():
    rng = np.random.default_rng(23)
    return _random_cases(rng) + [(r, d) for r, d, _ in _tiny_streams(24)]


def test_encode_plan_matches_jax():
    cases = _encode_cases()
    raws, descs = [r for r, _ in cases], [d for _, d in cases]
    got = PackedEncoder(lane_px=2048, device="cpu").plan_and_pack(raws, descs)
    want = jpacked.PackedEncoder(lane_px=2048).plan_and_pack(
        raws, [_jdesc(d) for d in descs])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2] == want[2] and got[3] == want[3]


def test_plan_lanes_balanced_matches_jax():
    rng = np.random.default_rng(4)
    slots = [int(x) for x in rng.integers(3, 900, 57)]
    wts = [s + 1.2 * int(c) for s, c in zip(slots, rng.integers(1, 90, 57))]
    for n_lanes, cap in ((8, 8192), (16, 4096), (3, 1 << 14)):
        got = packed.plan_lanes_balanced(slots, n_lanes, cap, wts)
        assert got == jpacked.plan_lanes_balanced(slots, n_lanes, cap, wts)
    with pytest.raises(ValueError, match="too small"):
        packed.plan_lanes_balanced(slots, 2, 1000)


@pytest.mark.parametrize("caps", ["planned", "tight out_cap",
                                  "tight chunk_cap"])
def test_encode_lanes_checked_matches_jax(caps):
    rng = np.random.default_rng(8)
    # tight chunk_cap: lanes of 8,192 slots, two filled by noise images,
    # at K3's smallest cap (4,096 rows), so that the sentinel row clamps
    # to chunk_cap - 1 in those lanes
    side, lane_px = (90, 8192) if caps == "tight chunk_cap" else (45, 2048)
    big = [(rng.integers(0, 256, side * side * 4, np.uint8),
            Desc(side, side, Channels.RGBA)) for _ in range(2)]  # > 8 KB each
    cases = _encode_cases() + big
    raws, descs = [r for r, _ in cases], [d for _, d in cases]
    pk, flags, _, plan_caps = PackedEncoder(
        lane_px=lane_px, device="cpu").plan_and_pack(raws, descs)
    kw = dict(chunk_cap=plan_caps["chunk_cap"], out_cap=plan_caps["out_cap"],
              ends_cap=plan_caps["ends_cap"])
    if caps == "tight out_cap":
        kw["out_cap"] = 8192  # the lanes of the two big images overflow
    if caps == "tight chunk_cap":
        kw["chunk_cap"] = enc_ops.CBLK + 256
    pk_t = torch.from_numpy(pk.view(np.int32))
    flags_t = torch.from_numpy(flags)
    got = enc_ops.encode_lanes_checked(pk_t, flags_t, **kw)
    want = jenc.encode_lanes_checked(jnp.asarray(pk), jnp.asarray(flags), **kw)
    out, ends, nseg, ok = (x.numpy() for x in got)
    jout, jends, jnseg, jok = (np.asarray(x) for x in want)
    # the noise lanes overflow the planned byte cap too (finish() encodes
    # them again at the safe caps); the flags must agree lane by lane
    assert np.array_equal(ok, jok) and ok.any() and not ok.all()
    # a lane of more chunk rows than chunk_cap keeps its first chunk_cap:
    # the JAX K3's clamped DMA leaves its compacted rows undefined, so its
    # bytes and ends are not compared; every other lane, ok or not, whole
    _, _, keep, _ = enc_ops.lane_positions(pk_t, flags_t)
    cap = enc_ops.lane_caps(pk.shape[1], kw["chunk_cap"])[0]
    fit = keep.sum(dim=1).numpy() <= cap
    assert fit.all() == (caps != "tight chunk_cap") and fit.any()
    assert np.array_equal(nseg[fit], jnseg[fit])
    assert np.array_equal(out[fit], jout[fit])
    assert np.array_equal(ends[fit], jends[fit])  # 0 past nseg on both sides
    assert nseg.sum() == len(cases) or not fit.all()


@pytest.mark.parametrize("seed", [0, 1])
def test_last_same_hash_value_seg_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, n = 3, 4 * 64
    pal = rng.integers(0, 1 << 32, 7, dtype=np.uint64).astype(np.uint32)
    words = pal[rng.integers(0, 7, (b, n))]
    words[:, ::17] = 0  # the fresh table's value, a real hit
    noneq = rng.random((b, n)) < 0.7
    seg = np.cumsum(rng.random((b, n)) < 0.03, axis=1).astype(np.int32)
    seg[1] = 0  # one row of a single stream
    tw = torch.from_numpy(words.view(np.int32))
    got = words_to_numpy(enc_ops._last_same_hash_value_seg(
        tw, hash6(tw), torch.from_numpy(noneq), torch.from_numpy(seg)))
    for i in range(b):
        jw = jnp.asarray(words[i])
        want = np.asarray(jenc._last_same_hash_value_seg(
            jw, jnp.asarray(words_to_numpy(hash6(tw[i]))),
            jnp.asarray(noneq[i]), jnp.asarray(seg[i])))
        assert np.array_equal(got[i], want), i


# -- single-lane views, resets and the device default ---------------------


def test_one_stream_lanes():
    """B=1: one stream is one encode lane, and decodes alone in a grid of
    16 lanes; both equal the oracle and the JAX engines."""
    rng = np.random.default_rng(9)
    desc = Desc(37, 11, Channels.RGBA)
    raw = rng.integers(0, 4, 37 * 11 * 4).astype(np.uint8) * 60
    blob, _ = oracle.encode(raw, desc)
    enc = PackedEncoder(lane_px=4096, device="cpu")
    pk, flags, where, _ = enc.plan_and_pack([raw], [desc])
    assert pk.shape[0] == 1 and where == [(0, 0)]
    assert np.array_equal(enc.encode([raw], [desc])[0], blob)
    assert np.array_equal(
        jpacked.PackedEncoder(lane_px=4096).encode([raw], [_jdesc(desc)])[0],
        blob)
    dec = PackedDecoder(device="cpu")
    assert np.array_equal(dec.decode([blob])[0], raw)
    regions, seg, chunks, _, _, qb, n_cap, l_total = dec.plan_and_pack([blob])
    got = words_to_numpy(packed._decode_lanes(
        torch.from_numpy(regions), torch.from_numpy(seg.astype(np.int64)),
        torch.from_numpy(chunks), qb, n_cap, l_total))
    ref = np.asarray(jpacked._decode_lanes(
        jnp.asarray(regions), jnp.asarray(seg), jnp.asarray(chunks), qb=qb,
        n_cap=n_cap, l_total=l_total))
    assert np.array_equal(got, ref)


def test_index53_opener_after_a_reset_in_lane():
    """A stream whose first chunk is INDEX 53 reads the start pixel: the
    decoder seeds slot 53 at every stream start, so a reset inside a lane
    must seed it again after the stream before wrote that slot."""
    # (r, g, b) whose opaque hash is 53 and that is not the start pixel
    p = next((r, g, 0) for r in range(1, 64) for g in range(64)
             if (3 * r + 5 * g + 11 * 255) % 64 == 53)
    desc = Desc(3, 1, Channels.RGB)
    body = bytes([0x35, 0xFE, *p, 0x35])
    blob = np.frombuffer(write_header(desc) + body + bytes(7) + b"\x01",
                         np.uint8)
    want = oracle.decode(blob, desc, desc.channels)
    assert np.array_equal(want.reshape(3, 3), [[0, 0, 0], p, p])
    blobs = [blob] * 32  # 32 equal streams over 16 lanes: two a lane
    dec = PackedDecoder(device="cpu")
    plan = dec.plan_and_pack(blobs)
    assert {li for li, poff in plan[3] if poff > 0}  # second streams exist
    for got in dec.decode(blobs):
        assert np.array_equal(got, want)
    jplan = jpacked.PackedDecoder().plan_and_pack(blobs)
    ref = np.asarray(jpacked._decode_lanes(
        *(jnp.asarray(x) for x in jplan[:3]), qb=jplan[5], n_cap=jplan[6],
        l_total=jplan[7]))
    got = words_to_numpy(dec.dispatch_staged(dec.stage_plan(plan))[0])
    assert np.array_equal(got, ref)


def test_device_entry_points_default_to_the_card():
    # decided when the test runs: without a card, no silent CPU run
    if torch.cuda.is_available():
        assert PackedDecoder().device.type == "cuda"
        assert PackedEncoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PackedDecoder()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PackedEncoder()

