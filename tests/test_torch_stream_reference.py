"""The port's streaming codec (``DeviceStreamDecoder`` /
``DeviceStreamEncoder`` on the CPU, the kernels' plain versions) against
the benchmark's plain reference (``portbench/reference.py``: ``qoi.h`` in
plain PyTorch, importing nothing of the port) on small seeded mosaics made
by ``portbench/mosaic.py``, as the streaming cells compare them on the
card: decoded pixels equal the mosaic's, encoded bytes equal the
reference's stream.  And the mosaic itself: deterministic by seed, of the
right geometry, each tile flipped as drawn."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import mosaic, reference
from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.ops.device_stream import (DeviceStreamDecoder,
                                               DeviceStreamEncoder)

torch.set_num_threads(1)

CORPUS = Path(__file__).resolve().parent / "resources" / "local_corpus"
# (file, crop's top-left row and column, its height and width): photo
# content in RGB, an icon's edges and alpha in RGBA
CROPS = {"rgb": ("photo_china_1080p.qoi", 400, 800, 24, 32),
         "rgba": ("icon_image.qoi", 160, 150, 24, 32)}


def _crop(kind):
    name, y, x, h, w = CROPS[kind]
    data = np.fromfile(CORPUS / name, np.uint8)
    d = oracle.read_header(data)
    px = oracle.decode(data, d, d.channels).reshape(d.height, d.width,
                                                    int(d.channels))
    return np.ascontiguousarray(px[y: y + h, x: x + w])


def _image(kind, seed=2 ** 33 + 5):
    """A 4 x 4 mosaic of the kind's crop: its pixels, Desc and the
    reference's stream."""
    img = mosaic.make(_crop(kind), 4, 4, seed)
    h, w, c = img.shape
    raw = img.reshape(-1)
    stream = reference.encode(torch.from_numpy(raw),
                              reference.Header(w, h, c, 0)).stream.numpy()
    return raw, Desc(w, h, Channels(c)), stream


# (direction, image, codec keyword arguments, feed: bytes a decode_window
# call or pixels an encode_window call)
CASES = {
    "decode-rgb-4k": ("decode", "rgb", dict(window_cap=4096), 4096),
    "decode-rgb-64k": ("decode", "rgb", dict(window_cap=1 << 16), 1 << 16),
    "decode-rgb-4k-feed1000": ("decode", "rgb", dict(window_cap=4096), 1000),
    "decode-rgba-4k-feed997": ("decode", "rgba", dict(window_cap=4096),
                               997),
    "decode-rgb-4k-lanes8": ("decode", "rgb",
                             dict(window_cap=4096, split_lanes=8), 4096),
    "encode-rgb-4096": ("encode", "rgb", dict(window_px=4096), 4096),
    "encode-rgb-1000": ("encode", "rgb", dict(window_px=1000), 4096),
    "encode-rgb-4096-lanes8": ("encode", "rgb",
                               dict(window_px=4096, split_lanes=8), 4096),
    "encode-rgba-1000-lanes8": ("encode", "rgba",
                                dict(window_px=1000, split_lanes=8), 3000),
    "encode-rgba-4096": ("encode", "rgba", dict(window_px=4096), 5000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_codec_matches_reference(case):
    direction, kind, kw, feed = CASES[case]
    raw, desc, stream = _image(kind)
    if direction == "decode":
        dec = DeviceStreamDecoder(device="cpu", **kw)
        assert dec.initialize(stream[:14]).value() == desc
        body = stream[14:-8]
        parts = []
        for i in range(0, body.size, feed):
            parts.append(dec.decode_window(body[i: i + feed]).value())
            # a QOI chunk is at most 5 bytes: at most 4 carried torn
            assert len(dec._leftover) <= 4
        assert not dec._leftover
        got = np.concatenate(parts)
        assert got.size == raw.size and np.array_equal(got, raw)
        assert len(dec.windows) > (1 if kw["window_cap"] == 4096 else 0)
    else:
        enc = DeviceStreamEncoder(device="cpu", **kw)
        parts = [enc.initialize(desc).value()]
        step = feed * int(desc.channels)
        parts += [enc.encode_window(raw[i: i + step]).value().tobytes()
                  for i in range(0, raw.size, step)]
        parts.append(enc.finalize().value())
        assert b"".join(parts) == stream.tobytes()


def test_mosaic_geometry_and_flips_follow_the_seed():
    tile = np.arange(3 * 5 * 4, dtype=np.uint8).reshape(3, 5, 4)
    img = mosaic.make(tile, 2, 3, seed=2 ** 40 + 1)
    assert img.shape == (6, 15, 4) and img.dtype == np.uint8
    assert np.array_equal(img, mosaic.make(tile, 2, 3, seed=2 ** 40 + 1))
    codes = mosaic.flips(2 ** 40 + 1, 6)
    assert set(codes.tolist()) <= {1, 2, 3}
    assert np.array_equal(codes, np.random.default_rng(
        [2 ** 40 + 1, 7]).integers(1, 4, 6))
    for k, code in enumerate(codes):
        i, j = divmod(k, 3)
        want = tile
        if code & mosaic.FLIP_H:
            want = want[:, ::-1]
        if code & mosaic.FLIP_V:
            want = want[::-1]
        assert np.array_equal(img[3 * i: 3 * i + 3, 5 * j: 5 * j + 5], want)
    # image k is row k of the seed's draw; another seed draws other flips
    rows = np.random.default_rng([2 ** 40 + 1, 7]).integers(1, 4, (3, 6))
    assert np.array_equal(mosaic.flips(2 ** 40 + 1, 6, 2), rows[2])
    second = mosaic.make(tile, 2, 3, seed=2 ** 40 + 1, image=1)
    assert np.array_equal(second[:3, :5],
                          mosaic.flipped(tile, int(rows[1][0])))
    others = [mosaic.flips(s, 16) for s in range(4)]
    assert any(not np.array_equal(others[0], o) for o in others[1:])
