"""The port's front end (qoipp_tpu_torch.api, stream, common, oracle)
against the golden fixtures, the native oracle and qoipp_tpu's, exact
(tolerance: equality): every case of test_api.py, test_edge_paths.py,
test_stream.py and test_common.py run against the port's modules on the
CPU, the device backend ("torch") with device="cpu" (each kernel's plain
version: K1 and K6 to decode, K3 and K4 to encode), tolerant decode of
truncated streams against the JAX package's api, and the host layer's
constants and helpers against qoipp_tpu.common's."""

import numpy as np
import pytest
import torch

import qoipp_tpu
import qoipp_tpu.common as jcommon
import qoipp_tpu_torch as q
from qoipp_tpu_torch import api, common, oracle

torch.set_num_threads(1)

DESC3 = q.Desc(29, 17, q.Channels.RGB)
DESC4 = q.Desc(24, 14, q.Channels.RGBA)
DEV = dict(backend="torch", device="cpu")


# -- the cases of test_api.py --------------------------------------------


def test_encode_golden(raw3, qoi3, raw4, qoi4):
    assert np.array_equal(q.encode(raw3, DESC3).value(), qoi3)
    assert np.array_equal(q.encode(raw4, DESC4).value(), qoi4)


def test_encode_torch_backend(raw3, qoi3):
    assert np.array_equal(q.encode(raw3, DESC3, **DEV).value(), qoi3)


def test_encode_errors(raw3):
    assert q.encode(b"", DESC3).error() == q.Error.EMPTY
    assert (q.encode(raw3, q.Desc(0, 17, q.Channels.RGB)).error()
            == q.Error.INVALID_DESC)
    assert q.encode(raw3[:-3], DESC3).error() == q.Error.MISMATCHED_DESC


def test_encode_generator(raw3, qoi3):
    px = raw3.reshape(-1, 3)

    def gen(i):
        return q.Pixel(int(px[i, 0]), int(px[i, 1]), int(px[i, 2]), 0)

    # RGB forces alpha 0xFF in the reader
    assert np.array_equal(q.encode(gen, DESC3).value(), qoi3)


def test_encode_into_buffer(raw3, qoi3):
    buf = np.zeros(q.worst_size(DESC3).value(), np.uint8)
    st = q.encode_into(buf, raw3, DESC3).value()
    assert st.complete and st.written == qoi3.size
    assert np.array_equal(buf[: st.written], qoi3)


def test_encode_into_insufficient(raw3, qoi3):
    # a partial encode stops at a chunk boundary
    buf = np.zeros(1007, np.uint8)
    st = q.encode_into(buf, raw3, DESC3).value()
    assert not st.complete and st.written <= 1007
    assert np.array_equal(buf[: st.written], qoi3[: st.written])


def test_encode_into_byte_sink(raw3, qoi3):
    got = []
    assert q.encode_into(got.append, raw3, DESC3).value() == qoi3.size
    assert np.array_equal(np.array(got, np.uint8), qoi3)


def test_encode_into_file(tmp_path, raw3, qoi3):
    p = tmp_path / "out.qoi"
    assert q.encode_into(p, raw3, DESC3).value() == qoi3.size
    assert np.array_equal(np.frombuffer(p.read_bytes(), np.uint8), qoi3)
    assert q.encode_into(p, raw3, DESC3).error() == q.Error.FILE_EXISTS
    assert q.encode_into(p, raw3, DESC3, overwrite=True).value() == qoi3.size
    assert q.encode_into(tmp_path, raw3, DESC3, overwrite=True).error() in (
        q.Error.FILE_EXISTS, q.Error.NOT_REGULAR_FILE)


def test_decode_golden(raw3, qoi3, raw4, qoi4):
    img = q.decode(qoi3).value()
    assert img.desc == DESC3 and np.array_equal(img.data, raw3)
    img4 = q.decode(qoi4).value()
    assert img4.desc == DESC4 and np.array_equal(img4.data, raw4)


def test_decode_torch_backend(raw3, qoi3):
    assert np.array_equal(q.decode(qoi3, **DEV).value().data, raw3)


def test_decode_channel_conversion(qoi3, raw3, qoi4, raw4):
    img = q.decode(qoi3, target=q.Channels.RGBA).value()
    assert img.desc.channels == q.Channels.RGBA
    px = img.data.reshape(-1, 4)
    assert np.array_equal(px[:, :3].reshape(-1), raw3)
    assert np.all(px[:, 3] == 255)
    img = q.decode(qoi4, target=q.Channels.RGB).value()
    assert np.array_equal(img.data, raw4.reshape(-1, 4)[:, :3].reshape(-1))


def test_decode_flip(qoi3, raw3):
    img = q.decode(qoi3, flip_vertically=True).value()
    rows = raw3.reshape(17, 29 * 3)
    assert np.array_equal(img.data.reshape(17, 29 * 3), rows[::-1])


def test_decode_errors():
    assert q.decode(b"").error() == q.Error.EMPTY
    assert q.decode(b"x" * 22).error() == q.Error.TOO_SHORT
    assert q.decode(b"x" * 30).error() == q.Error.NOT_QOI


def test_decode_incomplete(qoi3_incomplete):
    img = q.decode(qoi3_incomplete).value()  # truncated input still decodes
    assert img.desc == DESC3 and img.data.size == 29 * 17 * 3


def test_decode_file(tmp_path, qoi3, raw3):
    p = tmp_path / "img.qoi"
    p.write_bytes(qoi3.tobytes())
    assert np.array_equal(q.decode(p).value().data, raw3)
    assert q.decode(tmp_path / "nope.qoi").error() == q.Error.FILE_NOT_EXISTS
    assert q.decode(tmp_path).error() == q.Error.NOT_REGULAR_FILE


def test_decode_into_buffer(qoi3, raw3):
    buf = np.zeros(29 * 17 * 3, np.uint8)
    assert q.decode_into(buf, qoi3).value() == DESC3
    assert np.array_equal(buf, raw3)
    small = np.zeros(10, np.uint8)
    assert q.decode_into(small, qoi3).error() == q.Error.NOT_ENOUGH_SPACE


def test_decode_into_pixel_sink(qoi4, raw4):
    got = []
    desc = q.decode_into(lambda p: got.append(tuple(p)), qoi4).value()
    assert desc.width == 24
    assert np.array_equal(np.array(got, np.uint8).reshape(-1), raw4)


def test_decode_into_pixel_sink_vectorized(qoi4, raw4, qoi3, raw3):
    blocks = []

    def sink(a):
        blocks.append(np.array(a))

    sink.vectorized = True
    assert q.decode_into(sink, qoi4).value().width == 24
    assert np.array_equal(np.concatenate(blocks).reshape(-1), raw4)
    blocks.clear()
    q.decode_into(sink, qoi3)
    px = np.concatenate(blocks)
    assert np.array_equal(px[:, :3].reshape(-1), raw3)
    assert (px[:, 3] == 0xFF).all()


def test_decode_into_file(tmp_path, qoi3, raw3):
    p = tmp_path / "img.qoi"
    p.write_bytes(qoi3.tobytes())
    buf = np.zeros(29 * 17 * 3, np.uint8)
    assert q.decode_into(buf, p).value() == DESC3
    assert np.array_equal(buf, raw3)


def test_full_roundtrip_both_backends(raw4):
    for kw in (dict(backend="native"), DEV):
        enc = q.encode(raw4, DESC4, **kw).value()
        assert np.array_equal(q.decode(enc, **kw).value().data, raw4)


def test_encode_generator_vectorized(raw3, qoi3):
    px = raw3.reshape(-1, 3)

    def gen(ids):
        out = np.zeros((len(ids), 4), np.uint8)
        out[:, :3] = px[ids]
        return out  # alpha 0: RGB encode forces 0xFF

    assert np.array_equal(q.encode(gen, DESC3).value(), qoi3)


def test_oneshot_threshold_configuration(monkeypatch):
    assert api.ONESHOT_DEVICE_THRESHOLD is None  # the default
    api.set_oneshot_device_threshold(1 << 18)
    assert api.ONESHOT_DEVICE_THRESHOLD == 1 << 18
    api.set_oneshot_device_threshold(None)
    assert api.ONESHOT_DEVICE_THRESHOLD is None
    with pytest.raises(ValueError):
        api.set_oneshot_device_threshold(-1)
    monkeypatch.setenv("QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD", "262144")
    assert api._env_threshold() == 262144
    monkeypatch.setenv("QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD", "none")
    assert api._env_threshold() is None


# -- the cases of test_edge_paths.py -------------------------------------


def make(desc, seed=0):
    rng = np.random.default_rng(seed)
    n = desc.width * desc.height
    pal = rng.integers(0, 256, (5, int(desc.channels))).astype(np.uint8)
    raw = pal[rng.integers(0, 5, n)].reshape(-1)
    return raw, oracle.encode(raw, desc)[0]


def test_pipeline_target_conversion():
    desc = q.Desc(48, 24, q.Channels.RGB)
    raw, blob = make(desc)
    pipe = q.BatchPipeline(desc, device="cpu")
    streams, sizes = pipe.pack_streams([blob, blob])
    rgba = pipe.decode(streams, sizes, target=q.Channels.RGBA).numpy()
    assert rgba.shape == (2, 24, 48, 4)
    assert np.array_equal(rgba[0, :, :, :3].reshape(-1), raw)
    assert np.all(rgba[:, :, :, 3] == 255)


def test_device_stream_rgba_to_rgb():
    desc = q.Desc(32, 16, q.Channels.RGBA)
    raw, blob = make(desc, seed=1)
    dec = q.DeviceStreamDecoder(window_cap=256, device="cpu")
    d = dec.initialize(blob[:14], target=q.Channels.RGB).value()
    assert d.channels == q.Channels.RGB
    got = dec.decode_window(blob[14:-8]).value()
    assert np.array_equal(got, raw.reshape(-1, 4)[:, :3].reshape(-1))


def test_torch_backend_encode_into_buffer():
    desc = q.Desc(40, 20, q.Channels.RGB)
    raw, blob = make(desc, seed=2)
    buf = np.zeros(q.worst_size(desc).value(), np.uint8)
    st = q.encode_into(buf, raw, desc, **DEV).value()
    assert st.complete and st.written == blob.size
    assert np.array_equal(buf[: st.written], blob)
    # a buffer below the worst size takes the native partial encode
    small = np.zeros(blob.size - 10, np.uint8)
    st2 = q.encode_into(small, raw, desc, **DEV).value()
    assert not st2.complete
    assert np.array_equal(small[: st2.written], blob[: st2.written])


def test_colorspace_roundtrip():
    desc = q.Desc(8, 8, q.Channels.RGB, q.Colorspace.LINEAR)
    raw, blob = make(desc, seed=3)
    assert blob[13] == 1  # the colorspace byte is kept
    assert q.decode(blob).value().desc.colorspace == q.Colorspace.LINEAR
    blob2, _ = oracle.encode(raw, desc.replace(colorspace=q.Colorspace.SRGB))
    assert np.array_equal(blob[14:], blob2[14:])


def test_single_pixel_image():
    for ch in (q.Channels.RGB, q.Channels.RGBA):
        desc = q.Desc(1, 1, ch)
        raw = np.array([7, 8, 9, 200][: int(ch)], np.uint8)
        blob = q.encode(raw, desc, **DEV).value()
        assert np.array_equal(blob, oracle.encode(raw, desc)[0])
        assert np.array_equal(q.decode(blob, **DEV).value().data, raw)


def test_max_run_image():
    desc = q.Desc(63, 1, q.Channels.RGBA)
    raw = np.tile(np.array([1, 2, 3, 4], np.uint8), 63)
    blob = q.encode(raw, desc, **DEV).value()
    assert np.array_equal(blob, oracle.encode(raw, desc)[0])
    assert np.array_equal(q.decode(blob, **DEV).value().data, raw)


def test_decode_into_larger_buffer_tail_untouched():
    desc = q.Desc(16, 8, q.Channels.RGB)
    raw, blob = make(desc, seed=4)
    buf = np.full(raw.size + 50, 0xAB, np.uint8)
    assert q.decode_into(buf, blob).value().channels == q.Channels.RGB
    assert np.array_equal(buf[: raw.size], raw)
    assert np.all(buf[raw.size:] == 0xAB)


# -- the cases of test_stream.py -----------------------------------------


def drive_encode(enc, raw, desc, buf_size):
    """A 14-byte header buffer, then the input fed in out-buffer-sized
    slices (whole-pixel truncation and re-feed)."""
    hdr = np.zeros(14, np.uint8)
    assert enc.initialize(hdr, desc).value() == 14
    result = bytearray(hdr.tobytes())
    out = np.zeros(buf_size, np.uint8)
    consumed = 0
    raw = np.asarray(raw, np.uint8)
    while consumed < raw.size:
        chunk = raw[consumed: consumed + max(buf_size, int(desc.channels))]
        r = enc.encode(out, chunk).value()
        result += out[: r.written].tobytes()
        consumed += r.processed
    need = 8 + (1 if enc.has_run_count() else 0)
    fin = np.zeros(need, np.uint8)
    assert enc.finalize(fin).value() == need
    result += fin.tobytes()
    return np.frombuffer(bytes(result), np.uint8)


def _drive_decode_raw(dec, data, buf_size, target=None):
    data = np.asarray(data, np.uint8)
    d = dec.initialize(data[:14], target).value()
    out = np.zeros(buf_size, np.uint8)
    result = bytearray()
    consumed, end = 14, data.size - 8
    while consumed < end:
        r = dec.decode(out, data[consumed: consumed + buf_size]).value()
        result += out[: r.written].tobytes()
        consumed += r.processed
        if r.processed == 0 and r.written == 0:
            break
    while dec.has_run_count():
        n = dec.drain_run(out).value()
        result += out[:n].tobytes()
    dec.reset()
    return d, np.frombuffer(bytes(result), np.uint8)


def drive_decode(dec, data, desc, buf_size, target=None):
    """Input stops before the end marker, then pending runs drain."""
    d, got = _drive_decode_raw(dec, data, buf_size, target)
    return d, got[: d.width * d.height * int(d.channels)]


_BANDS = [(lo, min(lo + 64, 1025)) for lo in range(5, 1025, 64)]


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_encode_sweep_rgb(raw3, qoi3, band):
    enc = q.StreamEncoder()
    for buf_size in range(*band):
        assert np.array_equal(drive_encode(enc, raw3, DESC3, buf_size),
                              qoi3), f"buf={buf_size}"


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_encode_sweep_rgba(raw4, qoi4, band):
    enc = q.StreamEncoder()
    for buf_size in range(*band):
        assert np.array_equal(drive_encode(enc, raw4, DESC4, buf_size),
                              qoi4), f"buf={buf_size}"


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_decode_sweep_rgb(raw3, qoi3, band):
    dec = q.StreamDecoder()
    raw3_rgba = np.concatenate([raw3.reshape(-1, 3), np.full(
        (raw3.size // 3, 1), 255, np.uint8)], axis=1).reshape(-1)
    for buf_size in range(*band):
        d, got = drive_decode(dec, qoi3, DESC3, buf_size)
        assert d == DESC3 and np.array_equal(got, raw3), f"buf={buf_size}"
        _, got = drive_decode(dec, qoi3, DESC3, buf_size, q.Channels.RGB)
        assert np.array_equal(got, raw3), f"buf={buf_size} ->RGB"
        _, got = drive_decode(dec, qoi3, DESC3, buf_size, q.Channels.RGBA)
        assert np.array_equal(got, raw3_rgba), f"buf={buf_size} ->RGBA"


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_decode_sweep_rgba(raw4, qoi4, band):
    dec = q.StreamDecoder()
    raw4_rgb = np.ascontiguousarray(raw4.reshape(-1, 4)[:, :3]).reshape(-1)
    for buf_size in range(*band):
        _, got = drive_decode(dec, qoi4, DESC4, buf_size)
        assert np.array_equal(got, raw4), f"buf={buf_size}"
        _, got = drive_decode(dec, qoi4, DESC4, buf_size, q.Channels.RGBA)
        assert np.array_equal(got, raw4), f"buf={buf_size} ->RGBA"
        _, got = drive_decode(dec, qoi4, DESC4, buf_size, q.Channels.RGB)
        assert np.array_equal(got, raw4_rgb), f"buf={buf_size} ->RGB"


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_decode_sweep_incomplete_rgb(raw3, qoi3_incomplete, band):
    dec = q.StreamDecoder()
    for buf_size in range(*band):
        _, got = _drive_decode_raw(dec, qoi3_incomplete, buf_size)
        assert got.size < raw3.size, f"buf={buf_size}"
        assert np.array_equal(got, raw3[: got.size]), f"buf={buf_size}"


@pytest.mark.parametrize("band", _BANDS, ids=lambda b: f"{b[0]}-{b[1]-1}")
def test_decode_sweep_incomplete_rgba(raw4, qoi4_incomplete, band):
    dec = q.StreamDecoder()
    for buf_size in range(*band):
        _, got = _drive_decode_raw(dec, qoi4_incomplete, buf_size)
        assert got.size < raw4.size, f"buf={buf_size}"
        assert np.array_equal(got, raw4[: got.size]), f"buf={buf_size}"


def test_decoder_reuse_across_images(qoi3, raw3, qoi4, raw4):
    dec = q.StreamDecoder()
    for data, desc, raw in [(qoi3, DESC3, raw3), (qoi4, DESC4, raw4)] * 2:
        assert np.array_equal(drive_decode(dec, data, desc, 57)[1], raw)


def test_encoder_reuse(raw3, qoi3):
    enc = q.StreamEncoder()
    for _ in range(3):
        assert np.array_equal(drive_encode(enc, raw3, DESC3, 41), qoi3)


def test_decode_target_conversion(qoi3, raw3):
    d, got = drive_decode(q.StreamDecoder(), qoi3, DESC3, 100,
                          target=q.Channels.RGBA)
    assert d.channels == q.Channels.RGBA
    px = got.reshape(-1, 4)
    assert np.array_equal(px[:, :3].reshape(-1), raw3)
    assert np.all(px[:, 3] == 255)


def test_encoder_errors(raw3):
    enc = q.StreamEncoder()
    out = np.zeros(100, np.uint8)
    assert enc.encode(out, raw3).error() == q.Error.NOT_INITIALIZED
    assert enc.finalize(out).error() == q.Error.NOT_INITIALIZED
    assert enc.initialize(np.zeros(0, np.uint8), DESC3).error() == \
        q.Error.EMPTY
    assert enc.initialize(np.zeros(13, np.uint8), DESC3).error() == \
        q.Error.TOO_SHORT
    assert enc.initialize(out, DESC3).value() == 14
    assert enc.initialize(out, DESC3).error() == q.Error.ALREADY_INITIALIZED
    assert enc.encode(np.zeros(4, np.uint8), raw3).error() == \
        q.Error.TOO_SHORT
    assert enc.encode(out, b"").error() == q.Error.EMPTY
    enc.reset()
    assert not enc.is_initialized()


def test_decoder_errors(qoi3):
    dec = q.StreamDecoder()
    out = np.zeros(100, np.uint8)
    assert dec.decode(out, qoi3).error() == q.Error.NOT_INITIALIZED
    assert dec.drain_run(out).error() == q.Error.NOT_INITIALIZED
    assert dec.initialize(b"").error() == q.Error.EMPTY
    assert dec.initialize(b"qoif").error() == q.Error.TOO_SHORT
    assert dec.initialize(b"nope" * 4).error() == q.Error.NOT_QOI
    assert dec.initialize(qoi3[:14]).value() == DESC3
    assert dec.initialize(qoi3[:14]).error() == q.Error.ALREADY_INITIALIZED
    assert dec.decode(np.zeros(2, np.uint8), qoi3[14:]).error() == \
        q.Error.TOO_SHORT
    dec.reset()
    assert not dec.is_initialized()


def test_stream_roundtrip_random_sizes():
    rng = np.random.default_rng(42)
    for trial in range(3):
        w, h = int(rng.integers(10, 80)), int(rng.integers(10, 60))
        ch = q.Channels.RGBA if trial % 2 else q.Channels.RGB
        desc = q.Desc(w, h, ch)
        raw = (rng.integers(0, 6, w * h * int(ch)) * 13).astype(np.uint8)
        want, _ = oracle.encode(raw, desc)
        enc_buf = int(rng.integers(5, 200))
        dec_buf = int(rng.integers(int(ch), 200))
        got_enc = drive_encode(q.StreamEncoder(), raw, desc, enc_buf)
        assert np.array_equal(got_enc, want)
        _, got_dec = drive_decode(q.StreamDecoder(), got_enc, desc, dec_buf)
        assert np.array_equal(got_dec, raw)


def test_pending_run_across_calls():
    desc = q.Desc(63, 1, q.Channels.RGB)
    raw = np.full(189, 9, np.uint8)
    raw[:3] = (1, 2, 3)
    enc, _ = oracle.encode(raw, desc)
    dec = q.StreamDecoder()
    dec.initialize(enc[:14]).value()
    out = np.zeros(30, np.uint8)  # 10 pixels a call
    result = bytearray()
    consumed, end = 14, enc.size - 8
    while consumed < end:
        r = dec.decode(out, enc[consumed:end]).value()
        result += out[: r.written].tobytes()
        consumed += r.processed
        if r.processed == 0 and r.written == 0:
            break
    assert dec.has_run_count()
    while dec.has_run_count():
        result += out[: dec.drain_run(out).value()].tobytes()
    assert np.array_equal(np.frombuffer(bytes(result), np.uint8)[:189], raw)


# -- the cases of test_common.py -----------------------------------------


def test_is_valid():
    assert q.is_valid(DESC3) and q.is_valid(DESC4)
    assert not q.is_valid(q.Desc(0, 17, q.Channels.RGB))
    assert not q.is_valid(q.Desc(29, 0, q.Channels.RGB))


def test_count_bytes():
    assert q.count_bytes(DESC3).value() == 29 * 17 * 3
    assert q.count_bytes(DESC4).value() == 24 * 14 * 4
    r = q.count_bytes(q.Desc(0, 1, q.Channels.RGB))
    assert not r and r.error() == q.Error.INVALID_DESC
    r = q.count_bytes(q.Desc(2**33, 2**33, q.Channels.RGB))
    assert not r and r.error() == q.Error.TOO_BIG


def test_worst_size():
    assert q.worst_size(DESC3).value() == 4 * 29 * 17 + 22
    assert q.worst_size(DESC4).value() == 5 * 24 * 14 + 22


def test_header_roundtrip():
    hdr = q.write_header(DESC3)
    assert len(hdr) == q.HEADER_SIZE and hdr[:4] == b"qoif"
    got = q.read_header(hdr)
    assert got and got.value() == DESC3


def test_header_big_endian_layout():
    hdr = q.write_header(q.Desc(0x01020304, 0x0A0B0C0D, q.Channels.RGBA,
                                q.Colorspace.LINEAR))
    assert list(hdr[4:8]) == [1, 2, 3, 4]
    assert list(hdr[8:12]) == [0x0A, 0x0B, 0x0C, 0x0D]
    assert hdr[12] == 4 and hdr[13] == 1


def test_read_header_fixture(qoi3, qoi4):
    assert q.read_header(qoi3).value() == DESC3
    assert q.read_header(qoi4).value() == DESC4
    assert oracle.read_header(qoi3) == DESC3  # the native parser too
    assert oracle.read_header(b"x" * 14) is None


def test_read_header_errors():
    assert q.read_header(b"").error() == q.Error.EMPTY
    assert q.read_header(b"qoif").error() == q.Error.TOO_SHORT
    assert q.read_header(b"x" * 14).error() == q.Error.NOT_QOI
    bad = bytearray(q.write_header(DESC3))
    bad[12] = 9
    assert q.read_header(bytes(bad)).error() == q.Error.INVALID_DESC
    zero_w = q.write_header(q.Desc(1, 1, q.Channels.RGB))
    zero_w = zero_w[:4] + b"\x00\x00\x00\x00" + zero_w[8:]
    assert q.read_header(zero_w).error() == q.Error.INVALID_DESC


def test_read_header_file(tmp_path, qoi3):
    p = tmp_path / "img.qoi"
    p.write_bytes(qoi3.tobytes())
    assert q.read_header(p).value() == DESC3
    assert q.read_header(tmp_path / "nope.qoi").error() == \
        q.Error.FILE_NOT_EXISTS
    assert q.read_header(tmp_path).error() == q.Error.NOT_REGULAR_FILE


def test_enum_helpers():
    assert q.to_channels(3) == q.Channels.RGB
    assert q.to_channels(4) == q.Channels.RGBA
    assert q.to_channels(5) is None
    assert q.to_colorspace(0) == q.Colorspace.SRGB
    assert q.to_colorspace(1) == q.Colorspace.LINEAR
    assert q.to_colorspace(2) is None
    for e in q.Error:
        assert q.to_string(e) != "Unknown"


# -- against the JAX package, and no silent fallback ----------------------


def test_host_layer_matches_jax():
    """Constants, error strings and Result's contract equal
    qoipp_tpu.common's."""
    for name in ("MAGIC", "HEADER_SIZE", "END_MARKER", "END_MARKER_SIZE",
                 "RUNNING_ARRAY_SIZE", "RUN_LIMIT", "OP_RGB", "OP_RGBA",
                 "OP_INDEX", "OP_DIFF", "OP_LUMA", "OP_RUN", "BIAS_OP_RUN",
                 "BIAS_OP_DIFF", "BIAS_OP_LUMA_G", "BIAS_OP_LUMA_RB",
                 "MIN_DIFF", "MAX_DIFF", "MIN_LUMA_G", "MAX_LUMA_G",
                 "MIN_LUMA_RB", "MAX_LUMA_RB", "START_PIXEL"):
        assert getattr(common, name) == getattr(jcommon, name), name
    for e in common.Error:
        assert common.to_string(e) == jcommon.to_string(jcommon.Error(int(e)))
    ok, err = common.make_result(7), common.make_error(common.Error.EMPTY)
    jok, jerr = jcommon.make_result(7), jcommon.make_error(jcommon.Error.EMPTY)
    assert (ok.has_value(), err.has_value()) == (jok.has_value(),
                                                 jerr.has_value())
    assert ok.value_or(1) == jok.value_or(1) == 7
    assert err.value_or(1) == jerr.value_or(1) == 1
    assert repr(ok) == repr(jok)
    with pytest.raises(ValueError, match="Data is empty"):
        err.value()
    d = common.Desc(3, 4, common.Channels.RGB)
    assert d.replace(width=9) == common.Desc(9, 4, common.Channels.RGB)
    assert tuple(common.Pixel(1, 2, 3)) == tuple(jcommon.Pixel(1, 2, 3))
    assert set(qoipp_tpu.__all__) <= set(q.__all__)


@pytest.mark.parametrize("name", ["incomplete rgb", "incomplete rgba",
                                  "cut mid-chunk", "body only"])
def test_tolerant_decode_matches_jax(name, qoi3_incomplete, qoi4_incomplete,
                                     qoi4):
    """Truncated streams decode as the reference's tolerant loop does:
    bytes past the stream read as zeros; the torch backend equals the
    native one and the JAX package's api."""
    data = {"incomplete rgb": qoi3_incomplete,
            "incomplete rgba": qoi4_incomplete,
            "cut mid-chunk": qoi4[: qoi4.size // 2 + 3],
            "body only": qoi4[: q.HEADER_SIZE + q.END_MARKER_SIZE + 1]}[name]
    for target in (None, q.Channels.RGB, q.Channels.RGBA):
        got = q.decode(data, target, **DEV).value()
        native = q.decode(data, target, backend="native").value()
        jt = None if target is None else qoipp_tpu.Channels(int(target))
        want = qoipp_tpu.decode(  # the JAX device decoder's own rule
            data, jt, backend="jax" if target is None else "native").value()
        assert got.desc == native.desc
        assert np.array_equal(got.data, native.data)
        assert np.array_equal(got.data, want.data)


def test_device_backend_never_runs_natively(raw3):
    """Without a card, an explicit device backend raises; auto with a
    threshold set stays native only because there is no card."""
    if torch.cuda.is_available():
        assert api._resolve_backend("auto", 0) == "native"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.encode(raw3, DESC3, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.decode(q.encode(raw3, DESC3).value(), backend="torch")
    # a buffer below the worst size would take the native partial encode:
    # the device is checked before that
    small = np.zeros(16, np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        q.encode_into(small, raw3, DESC3, backend="torch")
    assert not small.any()
    api.set_oneshot_device_threshold(0)
    try:
        assert api._resolve_backend("auto", 1 << 20) == "native"
        assert api._resolve_backend("torch", 1) == "torch"
    finally:
        api.set_oneshot_device_threshold(None)
