"""G1's plain version (ops/gather_kernel) and the one unpack path of the
packed and split decodes (models/packed.gather_streams) on the CPU: the
bytes each stream gets equal the word-to-bytes unpack the decoders made on
the host before (numpy shifts and masks of each stream's words), no byte
outside a segment changes, and the table refuses rows outside its source
or output."""

import numpy as np
import pytest
import torch

from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models import packed, serving, split
from qoipp_tpu_torch.ops import gather_kernel
from qoipp_tpu_torch.utils import tracing
from qoipp_tpu_torch.utils.corpus import make_corpus
from qoipp_tpu_torch.utils.transfer import fetch_pinned

SENTINEL = 0xA5


def _unpack_words(words: np.ndarray, channels: int) -> np.ndarray:
    """(N,) uint32 words -> (N * channels,) uint8: the host unpack the
    decoders made before the gather."""
    out = np.empty((words.size, channels), np.uint8)
    out[:, 0] = words & 0xFF
    out[:, 1] = (words >> 8) & 0xFF
    out[:, 2] = (words >> 16) & 0xFF
    if channels == 4:
        out[:, 3] = words >> 24
    return out.reshape(-1)


def _plane(rng, lanes, n_cap):
    return rng.integers(0, 1 << 32, (lanes, n_cap), dtype=np.uint32)


def _packed_tier(rng):
    """Lanes of back-to-back RGB and RGBA streams at odd pixel offsets,
    lane 3 empty."""
    n_cap = 8192
    streams, lane_px = [], [0, 0, 0, 0, 0]
    for k, (w, h) in enumerate([(17, 3), (5, 5), (64, 40), (1, 1), (33, 7),
                                (100, 20), (3, 1), (9, 9)]):
        lane = (0, 1, 2, 4)[k % 4]
        c = 4 if k % 3 else 3
        streams.append((Desc(w, h, Channels(c)), lane, lane_px[lane]))
        lane_px[lane] += w * h
    return _plane(rng, 5, n_cap), [
        (d, [(lane * n_cap + poff, 0, d.width * d.height)])
        for d, lane, poff in streams]


def _split_group(rng):
    """Two streams cut into runs of 1-700 pixels, one run a lane, so their
    bytes land at odd offsets of their streams."""
    n_cap = 1024
    plane = _plane(rng, 24, n_cap)
    out, lane = [], 0
    for w, h, c in ((97, 31, 3), (45, 20, 4)):
        cuts = np.sort(rng.choice(np.arange(1, w * h), 9, replace=False))
        bounds = [0, *cuts.tolist(), w * h]
        pieces = []
        for p0, p1 in zip(bounds[:-1], bounds[1:]):
            pieces.append((lane * n_cap, p0, p1 - p0))
            lane += 1
        out.append((Desc(w, h, Channels(c)), pieces))
    return plane, out


def _single_pixels(rng):
    """One-pixel streams at every source word alignment, RGB and RGBA."""
    n_cap = 64
    plane = _plane(rng, 2, n_cap)
    return plane, [(Desc(1, 1, Channels(3 + k // 2 % 2)),
                    [((k % 2) * n_cap + k, 0, 1)]) for k in range(8)]


def _empty_lane(rng):
    """One stream in lane 1 of three; lanes 0 and 2 hold nothing."""
    plane = _plane(rng, 3, 4096)
    return plane, [(Desc(50, 40, Channels.RGB), [(4096 + 5, 0, 2000)])]


CASES = {"packed tier": _packed_tier, "split group": _split_group,
         "single-pixel streams": _single_pixels, "empty lane": _empty_lane}


def _want(plane, streams):
    """Each stream's bytes by the old host unpack of its words."""
    flat = plane.reshape(-1)
    out = []
    for d, pieces in streams:
        words = np.empty(d.width * d.height, np.uint32)
        for w, p0, n in pieces:
            words[p0: p0 + n] = flat[w: w + n]
        out.append(_unpack_words(words, int(d.channels)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_gather_equals_host_unpack(case):
    """Every segment's bytes as the old unpack gave them, and no byte of
    the output outside the segments written (a sentinel around them)."""
    plane, streams = CASES[case](np.random.default_rng(sorted(CASES).index(
        case)))
    want = _want(plane, streams)
    sizes = [w.size for w in want]
    # a gap of 3 sentinel bytes before each stream: no two streams touch
    offs = np.cumsum([3] + [s + 3 for s in sizes])[:-1]
    table = gather_kernel.segment_table(
        (w, n, int(off) + p0 * int(d.channels), int(d.channels))
        for (d, pieces), off in zip(streams, offs) for w, p0, n in pieces)
    out = torch.full((int(offs[-1]) + sizes[-1] + 5,), SENTINEL,
                     dtype=torch.uint8)
    src = torch.from_numpy(plane.view(np.int32))
    assert gather_kernel.gather_pixels(src, table, out) is out
    got = out.numpy()
    mask = np.ones(got.size, bool)
    for off, w in zip(offs, want):
        assert np.array_equal(got[off: off + w.size], w)
        mask[off: off + w.size] = False
    assert (got[mask] == SENTINEL).all()
    # gather_streams: the same bytes, each result its own slice
    results = packed.gather_streams([(src, [
        (i, d, pieces) for i, (d, pieces) in enumerate(streams)])])
    assert [r.size for r in results] == sizes
    for r, w in zip(results, want):
        assert np.array_equal(r, w)


def test_segment_table_tiles():
    """Each row's first tile counts the tiles of the rows before it, a
    tile TILE_PX pixels from the first word rounded down to 4; rows of no
    pixels are dropped."""
    t = gather_kernel.TILE_PX
    table = gather_kernel.segment_table([
        (0, t, 0, 4), (3, t - 3, 0, 3), (5, 0, 0, 3), (6, t - 1, 0, 4),
        (8, 1, 0, 3)])
    assert table.dtype == np.int64 and table.shape == (4, 5)
    assert table[:, 4].tolist() == [0, 1, 2, 4]
    assert gather_kernel.segment_table([]).shape == (0, 5)


@pytest.mark.parametrize("row", [(0, 11, 0, 3), (-1, 2, 0, 3), (0, 2, -1, 4),
                                 (0, 2, 0, 2), (0, 2, 3, 4), (9, 2, 0, 3)],
                         ids=["past the source", "before the source",
                              "before the output", "two channels",
                              "past the output", "from past the source"])
def test_gather_refuses_rows_outside(row):
    src = torch.zeros(10, dtype=torch.int32)
    out = torch.zeros(10, dtype=torch.uint8)
    table = np.asarray([[*row, 0]], np.int64)
    with pytest.raises(ValueError):
        gather_kernel.gather_pixels(src, table, out)


def test_fetch_pinned_returns_a_fresh_array():
    t = torch.arange(12, dtype=torch.uint8)
    with tracing.collect() as tr:
        host = fetch_pinned(t)
    assert np.array_equal(host, t.numpy())
    assert not np.shares_memory(host, t.numpy())
    c = {k: v for (_, k), v in tr.counters.items()}
    assert c == {"d2h_bytes": 12, "host_syncs": 1}
    assert [s.name for s in tr.spans] == ["host.fetch"]


@pytest.mark.parametrize("engine", ["packed", "split", "serving"])
def test_decode_results_alias_no_later_call(engine):
    """Two calls' results share no memory, and each call's results one
    array between them, no two overlapping; the results equal the
    pixels."""
    _, raws, blobs = make_corpus(3, 64, 48, seed=4, channels=4)
    dec = {"packed": packed.PackedDecoder(device="cpu"),
           "split": split.SplitDecoder(lanes=8, device="cpu"),
           "serving": serving.ServingCodec(split_min_bytes=1 << 10,
                                           device="cpu")}[engine].decode
    first, second = dec(blobs), dec(blobs)
    for got in (first, second):
        for g, raw in zip(got, raws):
            assert np.array_equal(g, raw)
    for a in first:
        assert not any(np.shares_memory(a, b) for b in second)
    for j, a in enumerate(first):
        assert not any(np.shares_memory(a, b) for b in first[j + 1:])
