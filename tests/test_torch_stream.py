"""The port's device streaming codec (on CPU: E1, K2, K3, K4 and K5's plain
versions) against qoipp_tpu.ops.device_stream and the native oracle,
bit-exact: the window functions' bytes, lengths, carries and fixpoint
rounds, and both streaming classes on every case kind of
tests/test_device_stream.py (the same images, feeds, window sizes and
lanes), errors and the round trip included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu import Channels as JChannels
from qoipp_tpu import Desc as JDesc
from qoipp_tpu.models import split as jsplit
from qoipp_tpu.ops import device_stream as jds
from qoipp_tpu_torch import convert, oracle
from qoipp_tpu_torch.common import Channels, Desc, Error
from qoipp_tpu_torch.kernels.selfcheck import mixed_pixels
from qoipp_tpu_torch.models import split
from qoipp_tpu_torch.ops import device_stream as ds
from qoipp_tpu_torch.ops.bitops import START_PIXEL_PACKED
from qoipp_tpu_torch.ops.encode import TILE, pad_to_tile
from qoipp_tpu_torch.ops.fields_kernel import start_state

torch.set_num_threads(1)

DESC3 = Desc(29, 17, Channels.RGB)
DESC4 = Desc(24, 14, Channels.RGBA)


def _jdesc(d):
    return JDesc(d.width, d.height, JChannels(int(d.channels)))


def make_image(desc, seed=0):
    """tests/test_device_stream.py's image: 7 palette colours."""
    rng = np.random.default_rng(seed)
    ch = int(desc.channels)
    pal = rng.integers(0, 256, (7, ch)).astype(np.uint8)
    raw = pal[rng.integers(0, 7, desc.width * desc.height)].reshape(-1)
    return raw, oracle.encode(raw, desc)[0]


def _seam_heavy_image(w, h, ch, seed):
    """tests/test_device_stream.py's lane-seam image: runs spanning lanes,
    palette reuse, gradients and noise."""
    rng = np.random.default_rng(seed)
    n = w * h
    px = rng.integers(0, 256, (n, ch)).astype(np.uint8)
    px[n // 8 : n // 3] = 19
    pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
    px[n // 3 : n // 2] = pal[rng.integers(0, 6, n // 2 - n // 3)]
    ramp = (np.arange(n // 4) % 250).astype(np.uint8)
    px[n // 2 : n // 2 + n // 4] = ramp[:, None] // np.arange(1, ch + 1)
    return px.reshape(-1)


# --------------------------------------------------------------------------
# window functions
# --------------------------------------------------------------------------


def _raw_of(words, channels):
    b = words.view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(b[:, :channels]).reshape(-1)


def _stream_pixels(channels):
    """Mixed content with a run across the first window edge (1000) and a
    run counter of 61 at the second (2000), so the third window opens with
    a RUN-62 flush at its position 0."""
    px = mixed_pixels(np.random.default_rng(30 + channels), 3000)
    if channels == 3:
        px |= np.uint32(0xFF000000)
    px[900:1200] = px[899] ^ np.uint32(0x30303)
    px[1938:2100] = px[1937] ^ np.uint32(0x50505)
    return px


def _same_carry(carry, jcarry):
    for g, w in zip(convert.encoder_carry_to_jax(*carry), jcarry):
        assert g.shape == np.asarray(w).shape
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_window_matches_jax(channels):
    raw = _raw_of(_stream_pixels(channels), channels)
    window_px = 1000
    nb = pad_to_tile(window_px)
    jprev, jrun, jseen = (jnp.uint32(START_PIXEL_PACKED & 0xFFFFFFFF),
                          jnp.uint32(0), jnp.zeros(64, jnp.uint32))
    stream = bytearray()
    runs = []
    for s in range(0, raw.size // channels, window_px):
        cnt = min(window_px, raw.size // channels - s)
        buf = np.zeros(nb * channels, np.uint8)
        buf[: cnt * channels] = raw[s * channels : (s + cnt) * channels]
        # the port starts each window from the JAX package's carry
        carry = convert.encoder_carry_from_jax(
            np.asarray(jprev), np.asarray(jrun), np.asarray(jseen),
            device="cpu")
        out, length, *carry = ds._encode_window(
            torch.from_numpy(buf), cnt, *carry, channels=channels, nb=nb)
        jout, jlen, jprev, jrun, jseen = jds._encode_window(
            jnp.asarray(buf), jnp.int32(cnt), jprev, jrun, jseen,
            channels=channels, nb=nb)
        n = int(jlen)
        assert int(length) == n
        assert np.array_equal(out.numpy()[:n], np.asarray(jout)[:n])
        _same_carry(carry, (jprev, jrun, jseen))
        stream += out.numpy()[:n].tobytes()
        runs.append(int(jrun))
    assert runs[1] == 61  # the third window opens on a RUN-62 flush
    desc = Desc(raw.size // channels, 1, Channels(channels))
    tail = (bytes([0xC0 | (runs[-1] - 1)]) if runs[-1] else b"")
    want_stream = oracle.encode(raw, desc)[0]
    assert bytes(stream) + tail == want_stream[14:-8].tobytes()


@pytest.mark.parametrize("lanes", [4, 8])
def test_encode_window_lanes_matches_jax(lanes):
    raw = _seam_heavy_image(96, 40, 3, seed=11)
    window_px = 1024
    nb = -(-window_px // (lanes * TILE)) * lanes * TILE
    prev, run, seen = start_state(1, "cpu")
    prev, run, seen = prev[0], run[0], seen[:, 0]
    jcarry = (jnp.uint32(START_PIXEL_PACKED & 0xFFFFFFFF), jnp.uint32(0),
              jnp.zeros(64, jnp.uint32))
    n_total = raw.size // 3
    for s in range(0, n_total, window_px):
        cnt = min(window_px, n_total - s)
        buf = np.zeros(nb * 3, np.uint8)
        buf[: cnt * 3] = raw[s * 3 : (s + cnt) * 3]
        out, lens, prev, run, seen = ds._encode_window_lanes(
            torch.from_numpy(buf), cnt, prev, run, seen, channels=3, nb=nb,
            lanes=lanes)
        jout, jlens, *jcarry = jds._encode_window_lanes(
            jnp.asarray(buf), jnp.int32(cnt), *jcarry, channels=3, nb=nb,
            lanes=lanes)
        assert np.array_equal(lens.numpy(), np.asarray(jlens))
        for lane in range(lanes):
            n = int(lens[lane])
            assert np.array_equal(out[lane, :n].numpy(),
                                  np.asarray(jout)[lane, :n])
        _same_carry((prev, run, seen), jcarry)


@pytest.mark.parametrize("content,window_cap,chunk_domain", [
    ("noise", 1 << 15, True), ("palette", 1 << 13, False)])
def test_decode_window_lanes_matches_jax(content, window_cap, chunk_domain):
    rng = np.random.default_rng(5)
    desc = Desc(100, 100, Channels.RGB)
    if content == "noise":  # 4-byte RGB chunks: compaction pays
        raw = rng.integers(0, 256, 100 * 100 * 3, dtype=np.uint8)
    else:  # 1-byte INDEX chunks: the byte domain
        pal = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        raw = pal[rng.integers(0, 40, 100 * 100)].reshape(-1)
    blob = oracle.encode(raw, desc)[0]
    body = blob[14:-8].tobytes()
    dec = ds.DeviceStreamDecoder(window_cap=window_cap, split_lanes=8,
                                 device="cpu")
    dec.initialize(blob[:14]).value()
    prev, seen = dec._prev, dec._seen
    jprev, jseen = convert.window_carry_to_jax(prev, seen)
    pos, pixels, qcs = 0, [], []
    while pos < len(body):
        regions, seg_lens, offs, qb, qc, n_cap, _ = dec.plan_window(
            body[pos : pos + dec.window_cap])
        qcs.append(qc)
        lanes = regions.shape[0]
        packed, n_pix, consumed, prev, seen, rounds = split._decode_window_lanes(
            torch.from_numpy(regions), torch.from_numpy(seg_lens), prev, seen,
            lanes, qb=qb, n_cap=n_cap, qc=qc)
        jpacked, jn_pix, jconsumed, jprev, jseen, jrounds = (
            jsplit._decode_window_lanes(
                jnp.asarray(regions), jnp.asarray(seg_lens),
                jnp.asarray(jprev), jnp.asarray(jseen), jnp.int32(lanes),
                qb=qb, n_cap=n_cap, qc=qc))
        assert rounds == int(jrounds)
        assert np.array_equal(n_pix.numpy(), np.asarray(jn_pix))
        assert np.array_equal(consumed.numpy(), np.asarray(jconsumed))
        got, want = convert.words_to_numpy(packed), np.asarray(jpacked)
        for lane in range(lanes):
            k = int(n_pix[lane])
            assert np.array_equal(got[lane, :k], want[lane, :k])
            pixels.append(got[lane, :k])
        for g, w in zip(convert.window_carry_to_jax(prev, seen),
                        (jprev, jseen)):
            assert np.array_equal(g, np.asarray(w))
        nseg = int((seg_lens > 0).sum())
        pos += int(offs[nseg - 1]) + int(consumed[nseg - 1])
    assert (max(qcs) > 0) == chunk_domain and len(qcs) >= 2
    px = np.concatenate(pixels)
    want = raw.reshape(-1, 3)
    assert px.size == want.shape[0]
    assert np.array_equal(px.view(np.uint8).reshape(-1, 4)[:, :3], want)


# --------------------------------------------------------------------------
# the streaming classes, case by case as tests/test_device_stream.py
# --------------------------------------------------------------------------


def _decode_both(enc, feed, target=None, **kw):
    """Decode enc's chunks fed in `feed`-byte pieces with the port's and
    the JAX package's decoder; both outputs must agree piece by piece."""
    dec = ds.DeviceStreamDecoder(device="cpu", **kw)
    jdec = jds.DeviceStreamDecoder(**kw)
    d = dec.initialize(enc[:14], target=target).value()
    jd = jdec.initialize(enc[:14], target=target and JChannels(int(target)))
    assert (d.width, d.height, int(d.channels)) == (
        jd.value().width, jd.value().height, int(jd.value().channels))
    chunks = enc[14:-8]
    out = []
    for i in range(0, chunks.size, feed):
        got = dec.decode_window(chunks[i : i + feed]).value()
        assert np.array_equal(got, jdec.decode_window(chunks[i : i + feed])
                              .value())
        out.append(got)
    return np.concatenate(out)


def _encode_both(desc, raw, step_px, **kw):
    """Encode raw in step_px-pixel pieces with the port's and the JAX
    package's encoder; both streams must agree piece by piece."""
    ch = int(desc.channels)
    enc = ds.DeviceStreamEncoder(device="cpu", **kw)
    jenc = jds.DeviceStreamEncoder(**kw)
    stream = bytearray(enc.initialize(desc).value())
    assert bytes(stream) == jenc.initialize(_jdesc(desc)).value()
    for i in range(0, raw.size, step_px * ch):
        got = enc.encode_window(raw[i : i + step_px * ch]).value()
        assert np.array_equal(got, jenc.encode_window(
            raw[i : i + step_px * ch]).value())
        stream += got.tobytes()
    has_run = enc.has_run_count()
    assert has_run == jenc.has_run_count()
    tail = enc.finalize().value()
    assert tail == jenc.finalize().value()
    return np.frombuffer(bytes(stream) + tail, np.uint8), has_run


@pytest.mark.parametrize("feed", [7, 64, 333, 1019])
def test_decode_window_sweep(feed):
    raw, enc = make_image(DESC3, seed=1)
    assert np.array_equal(_decode_both(enc, feed, window_cap=1024), raw)


@pytest.mark.parametrize("feed", [11, 128, 500])
def test_decode_window_sweep_rgba(feed):
    raw, enc = make_image(DESC4, seed=2)
    assert np.array_equal(_decode_both(enc, feed, window_cap=512), raw)


def test_decode_target_conversion():
    raw, enc = make_image(DESC3, seed=3)
    got = _decode_both(enc, enc.size, target=Channels.RGBA,
                       window_cap=512).reshape(-1, 4)
    assert np.array_equal(got[:, :3].reshape(-1), raw)
    assert np.all(got[:, 3] == 255)


@pytest.mark.parametrize("window_px", [37, 100, 256])
def test_encode_window_sweep(window_px):
    raw, want = make_image(DESC3, seed=4)
    got, _ = _encode_both(DESC3, raw, window_px, window_px=window_px)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("window_px", [50, 129])
def test_encode_window_sweep_rgba(window_px):
    raw, want = make_image(DESC4, seed=5)
    got, _ = _encode_both(DESC4, raw, window_px, window_px=window_px)
    assert np.array_equal(got, want)


def test_encode_run_across_windows():
    desc = Desc(200, 1, Channels.RGB)
    raw = np.full(600, 7, np.uint8)
    raw[:3] = (1, 2, 3)
    got, has_run = _encode_both(desc, raw, 32, window_px=32)
    # 198 repeats of the second pixel: a RUN of 198 % 62 pending at finalize
    assert has_run and got[-9] == 0xC0 | (198 % 62 - 1)
    assert np.array_equal(got, oracle.encode(raw, desc)[0])


@pytest.mark.parametrize("lanes", [4, 8])
def test_encode_window_lanes_mixed(lanes):
    desc = Desc(96, 40, Channels.RGB)
    raw = _seam_heavy_image(96, 40, 3, seed=11)
    got, _ = _encode_both(desc, raw, 1024, window_px=1024, split_lanes=lanes)
    assert np.array_equal(got, oracle.encode(raw, desc)[0])


def test_encode_window_lanes_rgba():
    desc = Desc(64, 48, Channels.RGBA)
    raw = _seam_heavy_image(64, 48, 4, seed=12)
    raw[3::1024] = 7  # alpha flips across lane seams
    got, _ = _encode_both(desc, raw, 768, window_px=768, split_lanes=8)
    assert np.array_equal(got, oracle.encode(raw, desc)[0])


def test_encode_window_lanes_flat_runs():
    desc = Desc(1000, 3, Channels.RGB)
    raw = np.full(3000 * 3, 55, np.uint8)
    raw[:3] = (9, 8, 7)
    raw[1501 * 3 : 1502 * 3] = (1, 2, 3)  # one break mid-lane
    got, has_run = _encode_both(desc, raw, 1500, window_px=1500,
                                split_lanes=4)
    assert has_run
    assert np.array_equal(got, oracle.encode(raw, desc)[0])


def test_encode_window_lanes_index_chains():
    rng = np.random.default_rng(13)
    n = 4096
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, n)].reshape(-1)
    desc = Desc(n, 1, Channels.RGB)
    got, _ = _encode_both(desc, raw, n, window_px=n, split_lanes=8)
    assert np.array_equal(got, oracle.encode(raw, desc)[0])


def test_streaming_errors():
    dec = ds.DeviceStreamDecoder(window_cap=256, device="cpu")
    jdec = jds.DeviceStreamDecoder(window_cap=256)
    assert dec.decode_window(b"x").error() == Error.NOT_INITIALIZED
    assert dec.initialize(b"bad header....").error() == Error.NOT_QOI
    assert int(jdec.initialize(b"bad header....").error()) == Error.NOT_QOI
    raw, enc_bytes = make_image(DESC3, seed=1)
    dec.initialize(enc_bytes[:14]).value()
    assert dec.initialize(enc_bytes[:14]).error() == Error.ALREADY_INITIALIZED
    assert dec.decode_window(b"").error() == Error.EMPTY
    # 20,000 pixels from a few RUN bytes: past a pixel_cap of 8,192
    flat = oracle.encode(np.full(200 * 100 * 3, 9, np.uint8),
                         Desc(200, 100, Channels.RGB))[0]
    for cls, kw in ((ds.DeviceStreamDecoder, dict(device="cpu")),
                    (jds.DeviceStreamDecoder, {})):
        small = cls(window_cap=256, pixel_cap=8, **kw)
        small.initialize(flat[:14]).value()
        assert int(small.decode_window(flat[14:-8]).error()) == \
            Error.NOT_ENOUGH_SPACE

    enc = ds.DeviceStreamEncoder(device="cpu")
    jenc = jds.DeviceStreamEncoder()
    assert enc.encode_window(b"xxx").error() == Error.NOT_INITIALIZED
    assert enc.finalize().error() == Error.NOT_INITIALIZED
    assert int(jenc.finalize().error()) == Error.NOT_INITIALIZED
    enc.initialize(DESC3).value()
    jenc.initialize(_jdesc(DESC3)).value()
    assert enc.initialize(DESC3).error() == Error.ALREADY_INITIALIZED
    assert enc.encode_window(raw[:4]).error() == Error.MISMATCHED_DESC
    assert int(jenc.encode_window(raw[:4]).error()) == Error.MISMATCHED_DESC
    assert ds.DeviceStreamEncoder(device="cpu").initialize(
        Desc(0, 5, Channels.RGB)).error() == Error.INVALID_DESC


def test_streaming_classes_default_to_cuda():
    # decided when the test runs, on whichever machine runs it
    for cls in (ds.DeviceStreamDecoder, ds.DeviceStreamEncoder):
        if torch.cuda.is_available():
            assert cls().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls()


def test_roundtrip_device_stream():
    desc = Desc(64, 32, Channels.RGB)
    raw, _ = make_image(desc, seed=6)
    stream, _ = _encode_both(desc, raw, raw.size // 3, window_px=500)
    dec = ds.DeviceStreamDecoder(window_cap=4096, device="cpu")
    dec.initialize(stream[:14]).value()
    assert np.array_equal(dec.decode_window(stream[14:-8]).value(), raw)
    assert dec.windows and all(w["rounds"] >= 1 for w in dec.windows)
