"""The benchmark's reference against the committed corpus and against the
program's native oracle (a second, independent witness of qoi.h), and
the frozen generator against make_corpus."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import corpus, generator, reference
from portbench.spec import ROOT, Spec

CONFIG = Spec().config("serving_mixed_corpus")


def _encode(raw, w, h, ch, **kw):
    return reference.encode(torch.from_numpy(np.ascontiguousarray(raw)),
                            reference.Header(w, h, ch, 0), **kw)


@pytest.fixture(scope="module")
def committed():
    return corpus.load(ROOT, CONFIG)


def test_corpus_digests_hold(committed):
    assert committed.names == CONFIG["files"]
    assert len(committed.names) == 16


def test_corpus_refuses_changed_file(tmp_path):
    folder = tmp_path / "c"
    folder.mkdir()
    src = ROOT / CONFIG["dir"] / "icon_gaming.qoi"
    data = bytearray(src.read_bytes())
    data[100] ^= 1
    (folder / "icon_gaming.qoi").write_bytes(bytes(data))
    (tmp_path / "d.sha256").write_text(
        (ROOT / CONFIG["digests"]).read_text())
    cfg = dict(CONFIG, dir="c", digests="d.sha256", files=["icon_gaming.qoi"])
    with pytest.raises(RuntimeError, match="SHA-256"):
        corpus.load(tmp_path, cfg)


@pytest.mark.parametrize("name", CONFIG["files"])
def test_reference_round_trips_corpus_file(committed, name):
    """decode then encode gives back the committed file byte for byte, and
    the pixels equal the native oracle's."""
    from qoipp_tpu_torch import oracle
    from qoipp_tpu_torch.common import read_header

    i = committed.names.index(name)
    blob = committed.blobs[i]
    h = committed.headers[i]
    raw = reference.decode(blob)
    d = read_header(blob).value()
    assert np.array_equal(raw, np.asarray(
        oracle.decode(blob, d, d.channels)).reshape(-1))
    enc = _encode(raw, h.width, h.height, h.channels)
    assert np.array_equal(enc.stream.numpy(), blob)


def _edge_images():
    """(name, raw, w, h, ch): leading runs of the start pixel, transparent
    black (INDEX 0 against the empty table), runs of 61 to 125, alpha
    steps, wrap-around deltas."""
    w, h = 64, 32
    n = w * h
    start = np.tile(np.array([0, 0, 0, 255], np.uint8), n)
    zeros = np.zeros(n * 4, np.uint8)
    runs = np.zeros((n, 3), np.uint8)
    at = 0
    for k, length in enumerate((61, 62, 63, 124, 125, 1, 2)):
        runs[at: at + length] = (k * 37 % 256, 200, k)
        at += length
    runs[at:] = np.arange(n - at)[:, None] % 256
    rng = np.random.default_rng(5)
    alpha = rng.integers(0, 256, (n, 4), dtype=np.uint8)
    alpha[::3, 3] = 255
    wrap = np.zeros((n, 3), np.uint8)
    wrap[:, 0] = (np.arange(n) * 255) % 256  # steps of -1
    wrap[:, 1] = (np.arange(n) * 31) % 256  # LUMA range edge
    wrap[:, 2] = (np.arange(n) * 255 + (np.arange(n) // 7)) % 256
    mixed = start.copy()
    mixed[4 * 100: 4 * 200] = zeros[: 400]
    return [("start_pixel", start, w, h, 4), ("transparent", zeros, w, h, 4),
            ("runs", runs.reshape(-1), w, h, 3),
            ("alpha", alpha.reshape(-1), w, h, 4),
            ("wrap", wrap.reshape(-1), w, h, 3), ("mixed", mixed, w, h, 4)]


@pytest.mark.parametrize("case", range(6))
def test_reference_encode_matches_oracle_on_edges(case):
    from qoipp_tpu_torch import oracle
    from qoipp_tpu_torch.common import Channels, Desc

    name, raw, w, h, ch = _edge_images()[case]
    want, complete = oracle.encode(raw, Desc(w, h, Channels(ch)))
    assert complete, name
    enc = _encode(raw, w, h, ch)
    assert np.array_equal(enc.stream.numpy(), np.asarray(want)), name
    assert np.array_equal(reference.decode(want), raw), name


@pytest.mark.parametrize("ch", (3, 4))
def test_reference_encode_matches_oracle_on_generator(ch):
    from qoipp_tpu_torch import oracle
    from qoipp_tpu_torch.common import Channels, Desc

    for raw in generator.make_images(3, 96, 64, seed=11, channels=ch):
        want, _ = oracle.encode(raw, Desc(96, 64, Channels(ch)))
        enc = _encode(raw, 96, 64, ch)
        assert np.array_equal(enc.stream.numpy(), np.asarray(want))


def test_reference_counts_ops_and_kept():
    """ops: the chunks a decoder walks; kept: differing pixels and 62-run
    flush points, as a sequential count gives them."""
    raw = generator.make_images(1, 96, 64, seed=2)[0]
    enc = _encode(raw, 96, 64, 3)
    s = enc.stream.numpy()
    ops, p = 0, 14
    while p < s.size - 8:
        b = s[p]
        p += 5 if b == 0xFF else 4 if b == 0xFE else 2 if b >> 6 == 2 else 1
        ops += 1
    assert ops == enc.ops
    px = raw.reshape(-1, 3).astype(np.int64)
    word = px[:, 0] | px[:, 1] << 8 | px[:, 2] << 16 | 255 << 24
    prev = np.concatenate([[255 << 24], word[:-1]])
    kept, run = 0, 0
    for same in word == prev:
        run = run + 1 if same else 0
        kept += (not same) or run % 62 == 0
    assert kept == enc.kept


def test_control_stream_is_valid_but_not_the_reference():
    raw = generator.make_images(1, 96, 64, seed=4, channels=4)[0]
    ref = _encode(raw, 96, 64, 4).stream.numpy()
    ctl = _encode(raw, 96, 64, 4, index_ops=False).stream.numpy()
    assert not np.array_equal(ref, ctl)
    assert np.array_equal(reference.decode(ctl), raw)


def test_decode_refuses_truncated_stream():
    raw = generator.make_images(1, 48, 40, seed=1)[0]
    s = _encode(raw, 48, 40, 3).stream.numpy()
    with pytest.raises(ValueError):
        reference.decode(s[:-20])


def test_generator_is_make_corpus_and_seeded():
    from qoipp_tpu_torch.utils.corpus import make_corpus

    for ch in (3, 4):
        _, want, _ = make_corpus(3, 80, 64, seed=9, channels=ch)
        got = generator.make_images(3, 80, 64, seed=9, channels=ch)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    big = 2 ** 31 + 12345
    a = generator.make_images(2, 80, 64, seed=big)
    b = generator.make_images(2, 80, 64, seed=big)
    c = generator.make_images(2, 80, 64, seed=big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_raw_pixels_cache_is_keyed_and_reused(tmp_path, committed, monkeypatch):
    small = committed._replace(
        names=committed.names[4:5], blobs=committed.blobs[4:5],
        headers=committed.headers[4:5], digests=committed.digests[4:5])
    first = corpus.raw_pixels(tmp_path, small)
    files = list((tmp_path / corpus.CACHE).iterdir())
    assert len(files) == 1 and small.digests[0] in files[0].name

    def no_decode(_):
        raise AssertionError("decoded again")

    monkeypatch.setattr(reference, "decode", no_decode)
    again = corpus.raw_pixels(tmp_path, small)
    assert np.array_equal(first[0], again[0])
