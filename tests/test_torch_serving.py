"""The port's scheduler and serving codec (qoipp_tpu_torch.models.scheduler,
models.serving) against the native oracle and qoipp_tpu's, bit-exact
(tolerance: exact equality everywhere): every case of test_scheduler.py
and test_serving.py run through the port on the CPU (each kernel's plain
version), the serving routes (packed tiers, split groups, geometry
buckets) against the JAX ServingCodec's on the same inputs, and one
request through every engine."""

import numpy as np
import pytest
import torch

from qoipp_tpu.common import Channels as JChannels
from qoipp_tpu.common import Desc as JDesc
from qoipp_tpu.models import scheduler as jscheduler
from qoipp_tpu.models.serving import ServingCodec as JServingCodec
from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models import scheduler
from qoipp_tpu_torch.models.scheduler import BucketedCodec
from qoipp_tpu_torch.models.serving import ServingCodec

torch.set_num_threads(1)

CPU = dict(device="cpu")
DESC = Desc(64, 48, Channels.RGB)


def _jdesc(d):
    return JDesc(d.width, d.height, JChannels(int(d.channels)))


# -- the cases of test_scheduler.py --------------------------------------


def mixed_corpus(b=21, seed=0):
    rng = np.random.default_rng(seed)
    n = DESC.width * DESC.height
    raws, blobs = [], []
    for i in range(b):
        kind = i % 3
        if kind == 0:  # flat: tiny streams
            raw = np.full(n * 3, (i * 7) % 256, np.uint8)
        elif kind == 1:  # palette
            pal = rng.integers(0, 256, (8, 3)).astype(np.uint8)
            raw = pal[rng.integers(0, 8, n)].reshape(-1)
        else:  # noise: dense streams
            raw = rng.integers(0, 256, n * 3, np.uint8)
        raws.append(raw)
        blobs.append(oracle.encode(raw, DESC)[0])
    return raws, blobs


def test_bucketed_decode_parity_and_order():
    raws, blobs = mixed_corpus()
    codec = BucketedCodec(DESC, min_len=1 << 10, **CPU)
    imgs = codec.decode(blobs)
    assert imgs.shape == (len(blobs), DESC.height, DESC.width, 3)
    for i, raw in enumerate(raws):
        assert np.array_equal(imgs[i].reshape(-1), raw), f"image {i}"
    assert len(codec._pipes) >= 2  # several buckets were used


def test_bucketed_encode_with_hints_and_overflow_retry():
    raws, blobs = mixed_corpus(b=12, seed=3)
    codec = BucketedCodec(DESC, min_len=1 << 10, **CPU)
    # the dense images are under-hinted: they overflow their bucket and
    # are encoded again one bucket up
    hints = [max(b_.size // 2, 100) for b_ in blobs]
    streams = codec.encode(np.stack(raws), size_hints=hints)
    for i, b_ in enumerate(blobs):
        assert np.array_equal(streams[i], b_), f"image {i}"
    assert len(codec._pipes) >= 3  # the retry's buckets too


def test_bucketed_decode_rgba_target_conversion():
    raws, blobs = mixed_corpus(b=6, seed=5)
    imgs = BucketedCodec(DESC, min_len=1 << 10, **CPU).decode(
        blobs, target=Channels.RGBA)
    assert imgs.shape[-1] == 4
    for i in range(len(raws)):
        want = oracle.decode(blobs[i], DESC, Channels.RGBA)
        assert np.array_equal(imgs[i].reshape(-1), want)


def test_pad_b_grid_bounds_waste():
    assert scheduler._B_GRID == jscheduler._B_GRID
    assert scheduler._pad_b(1) == 1 and scheduler._pad_b(2) == 2
    for n in range(1, 600):
        p = scheduler._pad_b(n)
        assert p == jscheduler._pad_b(n)
        assert p >= n
        if n <= 256:
            assert p in scheduler._B_GRID and p * 2 <= n * 3
    for n in range(1, 17):
        assert scheduler._pad_b(n) * 3 <= n * 4, n


# -- the cases of test_serving.py ----------------------------------------


def make_corpus(seed=0, n=26):
    """Tiny icons, mid tiles, streams that out-size small pack lanes,
    mixed channels."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 4 == 0:  # tiny icons: packed
            d = Desc(8 + k % 5, 6, Channels.RGBA)
            raw = rng.integers(0, 256, d.width * d.height * 4, np.uint8)
        elif k % 4 == 1:  # flat mid: packed, run-heavy
            d = Desc(64, 48, Channels.RGB)
            raw = np.full(64 * 48 * 3, k, np.uint8)
        elif k % 4 == 2:  # noisy mid: over the cap of small lanes
            d = Desc(96, 64, Channels.RGB)
            raw = rng.integers(0, 256, 96 * 64 * 3, np.uint8)
        else:  # shared-geometry photos: the bucketed path groups these
            d = Desc(120, 80, Channels.RGBA)
            pal = rng.integers(0, 256, (17, 4), np.uint8)
            raw = pal[rng.integers(0, 17, 120 * 80)].reshape(-1)
        out.append((raw, d))
    return out


def _blobs(corpus):
    return [oracle.encode(r, d)[0] for r, d in corpus]


def test_decode_mixed_routes_and_parity():
    corpus = make_corpus()
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12, **CPU)
    n, packed_parts, split_parts = codec.decode_dispatch(_blobs(corpus))
    assert split_parts, "over-cap streams must route to the split engine"
    got = codec.decode_finish((n, packed_parts, split_parts))
    assert len(got) == len(corpus)
    for (raw, d), g in zip(corpus, got):
        assert np.array_equal(g, raw), f"{d.width}x{d.height}"


def test_resident_corpus_decodes_many_times():
    corpus = make_corpus(seed=3, n=14)
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12, **CPU)
    resident = codec.make_resident(_blobs(corpus))
    assert resident.n_streams == len(corpus)
    first, second = resident.decode(), resident.decode()
    for (raw, d), a, b in zip(corpus, first, second):
        assert np.array_equal(a, raw), f"{d.width}x{d.height}"
        assert np.array_equal(b, raw)


def test_decode_split_min_routes_big_streams():
    rng = np.random.default_rng(11)
    corpus = []
    for k in range(18):  # packable smalls
        d = Desc(20 + k, 16, Channels.RGB)
        corpus.append((rng.integers(0, 256, d.width * d.height * 3,
                                    np.uint8), d))
    for _ in range(2):  # big noisy streams, bodies far above split_min
        d = Desc(160, 160, Channels.RGBA)
        corpus.append((rng.integers(0, 256, 160 * 160 * 4, np.uint8), d))
    codec = ServingCodec(split_min_bytes=1 << 14, min_len=1 << 12, **CPU)
    n, packed_parts, split_parts = codec.decode_dispatch(_blobs(corpus))
    assert len(split_parts) == 1 and split_parts[0][0] == [18, 19]
    got = codec.decode_finish((n, packed_parts, split_parts))
    for (raw, _), g in zip(corpus, got):
        assert np.array_equal(g, raw)


def test_encode_mixed_routes_and_parity():
    corpus = make_corpus(seed=5)
    codec = ServingCodec(pack_lane_px=4096, min_len=1 << 12, **CPU)
    got = codec.encode([r for r, _ in corpus], [d for _, d in corpus])
    for (raw, d), g in zip(corpus, got):
        ref, complete = oracle.encode(raw, d)
        assert complete
        assert np.array_equal(g, ref), f"{d.width}x{d.height}"


def test_roundtrip_one_frontend():
    corpus = make_corpus(seed=9, n=13)
    codec = ServingCodec(pack_lane_bytes=8 << 10, pack_lane_px=4096,
                         min_len=1 << 12, **CPU)
    streams = codec.encode([r for r, _ in corpus], [d for _, d in corpus])
    for (raw, _), g in zip(corpus, codec.decode(streams)):
        assert np.array_equal(g, raw)


def test_all_packed_when_lanes_fit():
    corpus = make_corpus(seed=3, n=8)
    codec = ServingCodec(**CPU)  # the default lanes: everything packs
    blobs = _blobs(corpus)
    for (raw, _), g in zip(corpus, codec.decode(blobs)):
        assert np.array_equal(g, raw)
    streams = codec.encode([r for r, _ in corpus], [d for _, d in corpus])
    for b, s in zip(blobs, streams):
        assert np.array_equal(s, b)


def test_decode_tiered_packing():
    rng = np.random.default_rng(7)
    corpus = []
    for k in range(20):  # the small tier
        d = Desc(12 + k % 3, 10, Channels.RGB)
        corpus.append((rng.integers(0, 256, d.width * d.height * 3,
                                    np.uint8), d))
    for k in range(20):  # the big tier, more than 4x the small sizes
        d = Desc(160, 120, Channels.RGBA)
        pal = rng.integers(0, 256, (9, 4), np.uint8)
        corpus.append((pal[rng.integers(0, 9, 160 * 120)].reshape(-1), d))
    codec = ServingCodec(min_len=1 << 12, **CPU)
    n, packed_parts, split_parts = codec.decode_dispatch(_blobs(corpus))
    assert not split_parts, "everything fits the packed engine"
    assert len(packed_parts) >= 2, "size classes must tier"
    assert sorted(i for idxs, _ in packed_parts for i in idxs) == list(
        range(len(corpus)))
    got = codec.decode_finish((n, packed_parts, split_parts))
    for (raw, _), g in zip(corpus, got):
        assert np.array_equal(g, raw)


def test_serving_edge_inputs():
    codec = ServingCodec(**CPU)
    assert codec.decode([]) == []
    assert codec.encode([], []) == []
    d = Desc(9, 7, Channels.RGB)
    raw = np.arange(9 * 7 * 3, dtype=np.uint8)
    blob = oracle.encode(raw, d)[0]
    got = codec.decode([blob])
    assert len(got) == 1 and np.array_equal(got[0], raw)
    assert all(np.array_equal(g, raw) for g in codec.decode([blob] * 3))
    assert all(np.array_equal(e, blob) for e in codec.encode([raw, raw],
                                                             [d, d]))
    with pytest.raises(ValueError):
        codec.encode([raw], [d, d])


def test_decode_dispatch_overlapped_parity():
    corpus = make_corpus(seed=3)
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12, **CPU)
    plan = codec.decode_dispatch_overlapped(_blobs(corpus))
    assert plan[2], "over-cap streams must route to the split engine"
    got = codec.decode_finish(plan)
    assert len(got) == len(corpus)
    for (raw, d), g in zip(corpus, got):
        assert np.array_equal(g, raw), f"{d.width}x{d.height}"


def test_decode_stage_then_dispatch_parity():
    corpus = make_corpus(seed=5, n=18)
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12, **CPU)
    staged = codec.decode_stage(_blobs(corpus))
    got = codec.decode_finish(codec.decode_dispatch_staged(staged))
    for (raw, d), g in zip(corpus, got):
        assert np.array_equal(g, raw), f"{d.width}x{d.height}"


def test_encode_stage_then_dispatch_parity():
    corpus = make_corpus(seed=7, n=14)
    codec = ServingCodec(pack_lane_bytes=8 << 10, min_len=1 << 12,
                         pack_lane_px=4096, **CPU)
    raws, descs = [r for r, _ in corpus], [d for _, d in corpus]
    want = _blobs(corpus)
    staged = codec.encode_stage(raws, descs)
    assert staged[2], "the 96x64 and 120x80 images take the bucketed path"
    got = codec.encode_finish(codec.encode_dispatch_staged(staged))
    for w, g, d in zip(want, got, descs):
        assert np.array_equal(g, w), f"{d.width}x{d.height}"
    for w, g in zip(want, codec.encode(raws, descs)):
        assert np.array_equal(g, w)


# -- routes against the JAX ServingCodec, one request per engine ---------


def _jax_decode_routes(jcodec, blobs):
    """The JAX ServingCodec's decode routes, from its own helpers as its
    decode_dispatch takes them: (packed tiers, split groups)."""
    from qoipp_tpu.models.serving import _size_tiers

    arrs, descs = jcodec._parse(blobs)
    packable = jcodec._packable(arrs, descs)
    t = {i: max(arrs[i].size - 22, descs[i].width * descs[i].height)
         for i in packable}
    tiers = _size_tiers(packable, t, jcodec.DEC_TIER_SPAN,
                        jcodec.DEC_TIER_MIN)
    rest = [i for i in range(len(arrs)) if i not in set(packable)]
    return tiers, jcodec._split_groups(rest)


ROUTE_CONFIGS = {
    "small lanes": dict(pack_lane_bytes=8 << 10, min_len=1 << 12,
                        pack_lane_px=4096),
    "split_min": dict(split_min_bytes=1 << 12, split_lanes=8),
    "defaults": dict(),
}


@pytest.mark.parametrize("config", sorted(ROUTE_CONFIGS))
def test_routes_match_jax(config):
    """Packed tiers, split groups and encode's tiers and geometry buckets
    equal the JAX ServingCodec's on the same corpus."""
    kw = ROUTE_CONFIGS[config]
    corpus = make_corpus(seed=1, n=60)
    blobs = _blobs(corpus)
    codec, jcodec = ServingCodec(**kw, **CPU), JServingCodec(**kw)
    _, tiers, groups = codec._decode_routes(blobs)
    assert (tiers, groups) == _jax_decode_routes(jcodec, blobs)
    raws, descs = [r for r, _ in corpus], [d for _, d in corpus]
    _, etiers, by_geom = codec._encode_plan(raws, descs)
    _, jtiers, jby_geom = jcodec._encode_plan(raws,
                                              [_jdesc(d) for d in descs])
    assert etiers == jtiers and by_geom == jby_geom
    if config == "split_min":  # groups of at most split_lanes streams
        assert len(groups) >= 2 and max(len(g) for g in groups) == 8


def test_one_request_through_every_engine():
    """B=1 on each engine: a packed decode and encode, a split decode, a
    bucketed encode and a bucketed decode of one image."""
    rng = np.random.default_rng(13)
    d = Desc(96, 64, Channels.RGBA)
    raw = rng.integers(0, 256, 96 * 64 * 4, np.uint8)
    blob = oracle.encode(raw, d)[0]
    packed = ServingCodec(**CPU)
    assert np.array_equal(packed.decode([blob])[0], raw)
    assert np.array_equal(packed.encode([raw], [d])[0], blob)
    split = ServingCodec(split_min_bytes=1 << 12, split_lanes=16, **CPU)
    plan = split.decode_dispatch([blob])
    assert not plan[1] and plan[2][0][0] == [0]
    assert np.array_equal(split.decode_finish(plan)[0], raw)
    bucketed = ServingCodec(pack_lane_px=2048, min_len=1 << 12, **CPU)
    staged = bucketed.encode_stage([raw], [d])
    assert not staged[1] and staged[2][0][2].shape[0] == 1  # _pad_b(1)
    assert np.array_equal(
        bucketed.encode_finish(bucketed.encode_dispatch_staged(staged))[0],
        blob)
    codec = BucketedCodec(d, min_len=1 << 12, **CPU)
    assert np.array_equal(codec.decode([blob])[0].reshape(-1), raw)
    assert np.array_equal(codec.encode(raw[None])[0], blob)


def test_serving_defaults_to_the_card():
    # decided when the test runs: without a card, no silent CPU run
    if torch.cuda.is_available():
        assert ServingCodec().device.type == "cuda"
        assert BucketedCodec(DESC).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingCodec()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BucketedCodec(DESC)
