"""The bucketed decode into one device tensor
(``BucketedCodec.decode_to_device``) on the CPU, the kernels' plain
versions, against the benchmark's plain reference
(``portbench/reference.py``: ``qoi.h`` in plain PyTorch, importing
nothing of the port).  Small frames of mixed density, flat generator
frames beside crops of the committed 1080p photo, are encoded by the
reference and decode back to their own pixels in submission order: dense
and flat lanes interleaved, one bucket alone, a padded bucket, an RGBA
target.  The buckets' counters take their exact values, and the decode's
spans nest as the benchmark reads them, with no fetch."""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generator, reference
from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models.scheduler import BucketedCodec, _pad_b
from qoipp_tpu_torch.utils import tracing

torch.set_num_threads(1)

W, H = 96, 54
DESC = Desc(W, H, Channels.RGB)
N_PX = W * H
# the flat frames' streams (~3.1-3.3 KB) take the 4 KiB bucket, the photo
# crops' (10.6-11.6 KB) the 16 KiB one
MIN_LEN = 1 << 11
FLAT_BUCKET, PHOTO_BUCKET = 1 << 12, 1 << 14
CORPUS = Path(__file__).resolve().parent / "resources" / "local_corpus"
PHOTO_AT = ((400, 800), (600, 200), (800, 600))  # crops' top-left corners


@functools.cache
def _frames():
    """{"f": flat frames, "p": photo crops}, each a list of (raw pixels,
    the reference's stream)."""
    header = reference.Header(W, H, 3, 0)
    data = np.fromfile(CORPUS / "photo_china_1080p.qoi", np.uint8)
    d = oracle.read_header(data)
    photo = oracle.decode(data, d, d.channels).reshape(d.height, d.width, 3)
    raws = {"f": generator.make_images(6, W, H, seed=2 ** 33 + 1),
            "p": [np.ascontiguousarray(photo[y: y + H, x: x + W]).reshape(-1)
                  for y, x in PHOTO_AT]}
    return {k: [(r, reference.encode(torch.from_numpy(r),
                                     header).stream.numpy()) for r in v]
            for k, v in raws.items()}


def _batch(kinds: str):
    """The frames of ``kinds`` ("f" flat, "p" photo), each kind's next
    frame in turn: (raws, streams)."""
    frames = {k: iter(v) for k, v in _frames().items()}
    pairs = [next(frames[k]) for k in kinds]
    return [r for r, _ in pairs], [s for _, s in pairs]


def _codec():
    return BucketedCodec(DESC, min_len=MIN_LEN, device="cpu")


def test_frames_fill_two_buckets():
    codec = _codec()
    for kind, bucket in (("f", FLAT_BUCKET), ("p", PHOTO_BUCKET)):
        for _, stream in _frames()[kind]:
            assert codec._bucket_len(stream.size) == bucket


# order: kinds in submission order; one bucket alone, a bucket padded
# (five flat frames take six lanes), dense and flat lanes interleaved
ORDERS = {"interleaved": "fpfpfpf", "dense_first": "ppfff",
          "one_bucket": "ffff", "padded": "fffffppp", "one_dense": "p"}


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_decode_to_device_matches_reference_in_order(order):
    raws, blobs = _batch(ORDERS[order])
    codec = _codec()
    out = codec.decode_to_device(blobs)
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    assert out.shape == (len(blobs), H, W, 3)
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i].reshape(-1).numpy(), raw), (order, i)
    assert np.array_equal(codec.decode(blobs), out.numpy())
    assert len(codec._pipes) == len(set(ORDERS[order]))


def test_padded_bucket_drops_its_padding_lanes():
    assert _pad_b(5) == 6
    raws, blobs = _batch("fffffppp")
    plan = _codec().prepare(blobs)
    assert [(idxs, s.shape[0]) for idxs, _, s, _ in plan] == [
        ([0, 1, 2, 3, 4], 6), ([5, 6, 7], 3)]
    out = _codec().decode_to_device(blobs)
    assert out.shape[0] == len(raws)


def test_rgba_target_from_rgb_streams():
    raws, blobs = _batch("pfpf")
    out = _codec().decode_to_device(blobs, Channels.RGBA)
    assert out.shape == (4, H, W, 4)
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i, ..., :3].reshape(-1).numpy(), raw)
        assert bool((out[i, ..., 3] == 255).all())


def test_empty_batch():
    out = _codec().decode_to_device([])
    assert out.shape == (0, H, W, 3) and out.dtype == torch.uint8


def test_bucket_counters_exact():
    """Five flat frames in the 4 KiB bucket (six lanes), three photo crops
    in the 16 KiB one (three lanes): qb is the bucket's length in both."""
    _, blobs = _batch("fffffppp")
    want = {"bucket_streams": 8, "bucket_lanes": 6 + 3,
            "bucket_rows": 6 * FLAT_BUCKET + 3 * PHOTO_BUCKET,
            "bucket_stream_bytes": sum(b.size for b in blobs)}
    codec = _codec()
    with tracing.collect() as tr:
        with tracing.request(0):
            codec.decode_to_device(blobs)
        with tracing.request(1):
            codec.decode(blobs)
    # uploads count the packed streams and sizes, not the output positions
    plan = codec.prepare(blobs)
    data = sum(s.nbytes + z.nbytes for _, _, s, z in plan)
    for rid in (0, 1):
        got = {k: tr.counters.get((rid, k)) for k in want}
        assert got == want, rid
        assert tr.counters[(rid, "h2d_bytes")] == data, rid
    assert {p.qb for p in codec._pipes.values()} == {FLAT_BUCKET,
                                                      PHOTO_BUCKET}


def test_spans_of_a_resident_decode():
    """One routing span, each bucket's pack, boundary, unpack and index
    copy, inside the call; no fetch and no bytes fetched.  The host decode
    adds one fetch of the whole output."""
    _, blobs = _batch("pfpff")
    codec = _codec()
    with tracing.collect() as tr:
        with tracing.request(0), tracing.span("call"):
            codec.decode_to_device(blobs)
        with tracing.request(1):
            codec.decode(blobs, Channels.RGBA)
    names = [s.name for s in tr.spans if s.request == 0]
    for name, n in (("host.route", 1), ("host.pack_streams", 2),
                    ("host.upload", 4), ("decode.boundary", 2),
                    ("decode.unpack", 2), ("decode.assemble", 2),
                    ("host.fetch", 0)):
        assert names.count(name) == n, name
    assert (0, "d2h_bytes") not in tr.counters
    call = next(s for s in tr.spans if s.name == "call")
    top = {s.name for s in tr.spans if s.parent == call.id}
    assert {"host.route", "host.pack_streams",
            "decode.assemble"} <= top
    assert [s.name for s in tr.spans if s.request == 1].count(
        "host.fetch") == 1
    assert tr.counters[(1, "d2h_bytes")] == 5 * N_PX * 4
    assert not tracing.enabled()
