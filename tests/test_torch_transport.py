"""Chunked host-to-device staging of the port (qoipp_tpu_torch.utils.
transport) against the JAX package's (qoipp_tpu.utils.transport) and the
native oracle, bit-exact: test_utils.py's two staging cases run through the
port on the CPU (the serving codec at 512-byte chunks against itself
unchunked and against the JAX codec, and the edge arrays), each engine
that stages through stage_h2d chunked against unchunked and the oracle,
with the chunked path shown taken, and the setting's default."""

import numpy as np
import pytest
import torch

from qoipp_tpu.common import Channels as JChannels
from qoipp_tpu.common import Desc as JDesc
from qoipp_tpu.models.serving import ServingCodec as JServingCodec
from qoipp_tpu.utils import transport as jtransport
from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch.models import packed, serving, split
from qoipp_tpu_torch.models.serving import ServingCodec
from qoipp_tpu_torch.ops import device_stream
from qoipp_tpu_torch.utils import transport

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def chunked():
    """Set the chunk size for the test; 0 (off) again after it."""
    yield transport.set_h2d_chunk_bytes
    transport.set_h2d_chunk_bytes(0)


def _noise_corpus(seed, n=8):
    """test_utils.py's corpus: n noise images, 40 + 8k x 30, RGB and
    RGBA."""
    rng = np.random.default_rng(seed)
    corpus = []
    for k in range(n):
        d = Desc(40 + 8 * k, 30, Channels.RGB if k % 2 else Channels.RGBA)
        raw = rng.integers(0, 256, d.width * d.height * int(d.channels),
                           np.uint8)
        corpus.append((raw, d, oracle.encode(raw, d)[0]))
    return corpus


def test_chunk_bytes_default_off():
    assert transport.get_h2d_chunk_bytes() == 0
    assert jtransport.get_h2d_chunk_bytes() == 0


def test_chunked_h2d_staging_bit_identical(chunked):
    """The serving codec's decode and encode at 512-byte chunks equal the
    unchunked ones and the JAX codec's (test_utils.py's case)."""
    corpus = _noise_corpus(21)
    raws = [r for r, _, _ in corpus]
    descs = [d for _, d, _ in corpus]
    blobs = [b for _, _, b in corpus]
    kw = dict(pack_lane_bytes=8 << 10, min_len=1 << 12)
    codec = ServingCodec(**kw, device=CPU)
    want_dec, want_enc = codec.decode(blobs), codec.encode(raws, descs)
    chunked(512)
    got_dec, got_enc = codec.decode(blobs), codec.encode(raws, descs)
    jcodec = JServingCodec(**kw)
    j_dec = jcodec.decode(blobs)
    j_enc = jcodec.encode(raws, [JDesc(d.width, d.height,
                                       JChannels(int(d.channels)))
                                 for d in descs])
    for a, b, c, raw in zip(want_dec, got_dec, j_dec, raws):
        assert np.array_equal(a, b) and np.array_equal(b, np.asarray(c))
        assert np.array_equal(b, raw)
    for a, b, c, blob in zip(want_enc, got_enc, j_enc, blobs):
        assert np.array_equal(a, b) and np.array_equal(b, np.asarray(c))
        assert np.array_equal(b, blob)


@pytest.mark.parametrize("case", [
    ("a1, 64", np.arange(1000, dtype=np.uint8), 64, True),
    ("a2, 64", np.arange(64, dtype=np.uint32).reshape(8, 8), 64, True),
    ("a1, larger than the array", np.arange(1000, dtype=np.uint8), 1 << 20,
     False),
    ("scalar, 1", np.uint32(7), 1, False),
], ids=lambda c: c[0])
def test_stage_h2d_edges(chunked, monkeypatch, case):
    """test_utils.py's edge arrays, against the JAX stage_h2d too; the
    chunked path is taken exactly where the JAX rule takes it."""
    _, arr, chunk, cut = case
    one_shot = []
    real = transport.upload
    monkeypatch.setattr(transport, "upload",
                        lambda a, dev: one_shot.append(1) or real(a, dev))
    chunked(chunk)
    jtransport.set_h2d_chunk_bytes(chunk)
    try:
        want = np.asarray(jtransport.stage_h2d(arr))
    finally:
        jtransport.set_h2d_chunk_bytes(0)
    got = transport.stage_h2d(arr, CPU).numpy()
    assert np.array_equal(got.reshape(want.shape), want)
    assert np.array_equal(got.reshape(np.shape(arr)), arr)
    assert (not one_shot) == cut


def _spy(monkeypatch, module):
    """Count each stage_h2d call of ``module`` and each that went one-shot
    (transport.upload)."""
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
    return calls


# each engine's run: the corpus -> (its outputs, the oracle's)


def _split(corpus):
    dec = split.SplitDecoder(lanes=8, device=CPU)
    return ([dec.gather(*dec.decode_to_device([b])[:3])[0]
             for _, _, b in corpus[:2]], [r for r, _, _ in corpus[:2]])


def _packed_decode(corpus):
    return (packed.PackedDecoder(lane_bytes=16 << 10, device=CPU).decode(
        [b for _, _, b in corpus]), [r for r, _, _ in corpus])


def _packed_encode(corpus):
    return (packed.PackedEncoder(lane_px=4096, device=CPU).encode(
        [r for r, _, _ in corpus], [d for _, d, _ in corpus]),
        [b for _, _, b in corpus])


def _serving_bucket(corpus):
    # pack_lane_px (rounded up to 2,048) below these images sends each
    # geometry to a bucket, two images each, so that its batch has rows
    # to cut
    corpus = corpus[5:] * 2
    return (ServingCodec(pack_lane_px=64, min_len=1 << 12,
                         device=CPU).encode([r for r, _, _ in corpus],
                                            [d for _, d, _ in corpus]),
            [b for _, _, b in corpus])


def _device_stream(corpus):
    return ([device_stream.stream_decode(b, 2048, device=CPU)[0]
             for _, _, b in corpus[:2]], [r for r, _, _ in corpus[:2]])


ENGINES = {  # name: (the module whose stage_h2d it calls, its run)
    "split": (split, _split),
    "packed decode": (packed, _packed_decode),
    "packed encode": (packed, _packed_encode),
    "serving bucket": (serving, _serving_bucket),
    "device stream": (device_stream, _device_stream),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_chunked_equals_unchunked(chunked, monkeypatch, name):
    """Each engine's staged upload at 256-byte chunks: the results equal
    the unchunked run's and the oracle's, and at least one upload was
    cut into pieces."""
    module, run = ENGINES[name]
    corpus = _noise_corpus(5)
    want, ref = run(corpus)
    calls = _spy(monkeypatch, module)
    chunked(256)
    got, _ = run(corpus)
    assert calls["staged"] > calls["one_shot"]
    assert len(got) == len(want) == len(ref)
    for a, b, c in zip(want, got, ref):
        assert np.array_equal(a, b) and np.array_equal(b, c)
