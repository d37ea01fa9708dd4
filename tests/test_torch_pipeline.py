"""The port's BatchPipeline (on CPU: every kernel's plain version) against
qoipp_tpu's BatchPipeline and the native oracle, bit-exact: synthetic RGB
and RGBA corpora, the golden and truncated fixtures, a crafted stream,
channel conversion and the encode-overflow flag; the stream packing over
destinations that hold other bytes against a fresh zeroed pack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_corpus
from qoipp_tpu import Channels, Colorspace, Desc, oracle
from qoipp_tpu.common import END_MARKER, write_header
from qoipp_tpu.models.pipeline import BatchPipeline as JaxPipeline
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.models.pipeline import BatchPipeline
from qoipp_tpu_torch.ops.bitops import pixels_to_packed

torch.set_num_threads(1)

DESC3 = Desc(29, 17, Channels.RGB, Colorspace.SRGB)
DESC4 = Desc(24, 14, Channels.RGBA, Colorspace.SRGB)


def _pipes(desc, blobs, **kw):
    ml = max(b.size for b in blobs)
    args = dict(max_stream_len=ml, max_encode_len=ml + 4096)
    args.update(kw)
    return BatchPipeline(desc, device="cpu", **args), JaxPipeline(desc, **args)


def _check_decode(desc, blobs, pipe, jpipe):
    """decode_packed on [:, :n_px] equals the JAX pipeline and the oracle."""
    streams, sizes = pipe.pack_streams(blobs)
    got = words_to_numpy(pipe.decode_packed(streams, sizes))
    assert got.shape == (len(blobs), pipe.n_cap)
    want = np.asarray(jpipe.decode_packed(jnp.asarray(streams),
                                          jnp.asarray(sizes)))
    assert np.array_equal(got[:, : pipe.n_px], want[:, : pipe.n_px])
    for i, blob in enumerate(blobs):
        px = oracle.decode(blob, desc, desc.channels)
        ref = words_to_numpy(pixels_to_packed(torch.from_numpy(px),
                                              int(desc.channels)))
        assert np.array_equal(got[i, : pipe.n_px], ref), f"image {i}"


def _check_streams(out, lengths, blobs):
    out, lengths = out.numpy(), lengths.numpy()
    for i, blob in enumerate(blobs):
        assert lengths[i] == blob.size, f"image {i}"
        assert np.array_equal(out[i, : blob.size], blob), f"image {i}"
        assert not out[i, blob.size :].any()


@pytest.fixture(scope="module", params=[3, 4], ids=["rgb", "rgba"])
def corpus(request):
    if request.param == 3:
        desc, raws, blobs = make_corpus(4, 96, 64)
    else:
        desc, raws, blobs = make_corpus(4, 64, 48, channels=4)
    return desc, raws, blobs, *_pipes(desc, blobs)


def test_corpus_decode(corpus):
    desc, _, blobs, pipe, jpipe = corpus
    _check_decode(desc, blobs, pipe, jpipe)


def test_corpus_decode_whole_output(corpus):
    # past n_px too: K2's tail is the JAX package's
    _, _, blobs, pipe, jpipe = corpus
    streams, sizes = pipe.pack_streams(blobs)
    got = words_to_numpy(pipe.decode_packed(streams, sizes))
    want = np.asarray(jpipe.decode_packed(jnp.asarray(streams),
                                          jnp.asarray(sizes)))
    assert pipe.n_cap > pipe.n_px and np.array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_single_image_decode(channels):
    # B = 1: the lane-major (qb, 1) rows count as contiguous but keep their
    # row stride, which the plain replay must not view as bytes
    desc, _, blobs = make_corpus(1, 96, 64, channels=channels)
    pipe, jpipe = _pipes(desc, blobs)
    streams, sizes = pipe.pack_streams(blobs)
    got = words_to_numpy(pipe.decode_packed(streams, sizes))
    want = np.asarray(jpipe.decode_packed(jnp.asarray(streams),
                                          jnp.asarray(sizes)))
    assert got.shape == want.shape == (1, pipe.n_cap)
    assert np.array_equal(got, want)
    _check_decode(desc, blobs, pipe, jpipe)
    img = pipe.decode(streams, sizes)
    assert img.shape == (1, desc.height, desc.width, channels)
    assert np.array_equal(img[0].numpy().reshape(-1),
                          oracle.decode(blobs[0], desc, desc.channels))


def test_corpus_encode(corpus):
    desc, raws, blobs, pipe, jpipe = corpus
    raw = np.stack(raws)
    out, lengths = pipe.encode(raw.reshape(len(raws), desc.height,
                                           desc.width, -1))
    _check_streams(out, lengths, blobs)
    jout, jlen, jok = jpipe.encode_raw_checked(jnp.asarray(raw))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    assert np.array_equal(lengths.numpy(), np.asarray(jlen))
    assert bool(np.asarray(jok).all())


def test_corpus_encode_packed_chunked(corpus):
    desc, raws, blobs, pipe, _ = corpus
    packed = pixels_to_packed(torch.from_numpy(np.stack(raws)),
                              int(desc.channels))
    packed = torch.nn.functional.pad(packed, (0, pipe.nb - pipe.n_px))
    out, lengths, ok = pipe.encode_packed_chunked(packed, sub=2)
    assert bool(ok.all())
    _check_streams(out, lengths, blobs)
    out1, len1 = pipe.encode_packed(packed)
    assert torch.equal(out1, out) and torch.equal(len1, lengths)
    with pytest.raises(ValueError):
        pipe.encode_packed_chunked(packed, sub=3)  # 4 % 3 != 0


@pytest.mark.parametrize("desc,names", [
    (DESC3, ("image_qoi_3.bin", "image_qoi_3_incomplete.bin")),
    (DESC4, ("image_qoi_4.bin", "image_qoi_4_incomplete.bin")),
], ids=["rgb", "rgba"])
def test_golden_and_truncated_decode(desc, names):
    from conftest import load_fixture

    blobs = [load_fixture(n) for n in names]
    assert blobs[1].size < blobs[0].size  # the second stream is truncated
    pipe = BatchPipeline(desc, device="cpu")
    _check_decode(desc, blobs, pipe, JaxPipeline(desc))


@pytest.mark.parametrize("desc,raw,qoi", [
    (DESC3, "image_raw_3.bin", "image_qoi_3.bin"),
    (DESC4, "image_raw_4.bin", "image_qoi_4.bin"),
], ids=["rgb", "rgba"])
def test_golden_encode(desc, raw, qoi):
    from conftest import load_fixture

    out, lengths = BatchPipeline(desc, device="cpu").encode(load_fixture(raw)[None])
    _check_streams(out, lengths, [load_fixture(qoi)])


def test_load_files_matches_pack_streams(tmp_path):
    from conftest import load_fixture

    blobs = [load_fixture("image_qoi_3.bin"),
             load_fixture("image_qoi_3_incomplete.bin")]
    paths = []
    for i, blob in enumerate(blobs):
        paths.append(tmp_path / f"{i}.qoi")
        paths[-1].write_bytes(blob.tobytes())
    pipe = BatchPipeline(DESC3, device="cpu")
    streams, sizes = pipe.load_files(paths)
    want_streams, want_sizes = pipe.pack_streams(blobs)
    assert np.array_equal(streams, want_streams)
    assert np.array_equal(sizes, want_sizes)


def test_crafted_index53_stream():
    # a first chunk OP_INDEX 53 yields the decoder's seeded start pixel
    desc = Desc(2, 1, Channels.RGBA)
    stream = np.frombuffer(write_header(desc) + bytes([53, 53]) + END_MARKER,
                           np.uint8)
    pipe = BatchPipeline(desc, device="cpu")
    _check_decode(desc, [stream], pipe, JaxPipeline(desc))
    img = pipe.decode(*pipe.pack_streams([stream]))
    assert img[0, 0, 0].tolist() == [0, 0, 0, 255]


def test_decode_channel_conversion(corpus):
    desc, _, blobs, pipe, jpipe = corpus
    streams, sizes = pipe.pack_streams(blobs)
    target = Channels.RGBA if desc.channels == Channels.RGB else Channels.RGB
    got = pipe.decode(streams, sizes, target=target)
    assert got.shape == (len(blobs), desc.height, desc.width, int(target))
    want = np.asarray(jpipe.decode(jnp.asarray(streams), jnp.asarray(sizes),
                                   target=target))
    assert np.array_equal(got.numpy(), want)
    for i, blob in enumerate(blobs):
        assert np.array_equal(got[i].numpy().reshape(-1),
                              oracle.decode(blob, desc, target))


def test_encode_overflow_flag():
    rng = np.random.default_rng(23)
    desc = Desc(40, 32, Channels.RGBA)
    n = 40 * 32 * 4
    raws = np.stack([
        (rng.integers(0, 4, n) * 60).astype(np.uint8),
        rng.integers(0, 256, n, dtype=np.uint8),  # noise: near-worst size
        np.zeros(n, np.uint8),
    ])
    blobs = [oracle.encode(r, desc)[0] for r in raws]
    assert min(b.size for b in blobs[:2]) > 1024 > blobs[2].size
    tight = BatchPipeline(desc, max_encode_len=1024, device="cpu")
    out, lengths, ok = tight.encode_raw_checked(raws)
    jout, jlen, jok = JaxPipeline(desc, max_encode_len=1024).encode_raw_checked(
        jnp.asarray(raws))
    assert ok.tolist() == np.asarray(jok).tolist() == [False, False, True]
    _check_streams(out[2:], lengths[2:], blobs[2:])
    assert np.array_equal(out[2].numpy(), np.asarray(jout)[2])
    with pytest.raises(ValueError, match="encode overflow"):
        tight.encode(raws)


def _fresh_pack(blobs, l_cap):
    """The packing as a fresh zeroed plane: each stream copied into its
    row, the rest left zero."""
    out = np.zeros((len(blobs), l_cap), np.uint8)
    for i, blob in enumerate(blobs):
        out[i, : blob.size] = blob
    return out, np.array([b.size for b in blobs], np.int32)


# batch: a mixed-length corpus; the same with header-only padding lanes
# (as BucketedCodec.prepare pads a bucket); one stream over l_cap
PACK_BATCHES = ("mixed", "header_padded", "overflow")


@pytest.mark.parametrize("dest", ["ff", "longer_batch"])
@pytest.mark.parametrize("batch", PACK_BATCHES)
def test_pack_into_used_destination_matches_fresh_pack(batch, dest):
    """pack_into writes every byte of a destination that holds anything
    (a card's pinned block handed out again), so it gives byte for byte
    the fresh zeroed pack; the CPU pipeline's pack_streams gives the same
    as numpy arrays that torch.from_numpy takes."""
    from qoipp_tpu_torch.models.pipeline import pack_into

    desc, _, blobs = make_corpus(5, 96, 64, seed=5)
    blobs = [b[: b.size - 40 * i] for i, b in enumerate(blobs)]  # mixed
    pipe = BatchPipeline(desc, max_stream_len=max(b.size for b in blobs),
                         device="cpu")
    if batch == "header_padded":
        blobs = blobs[:3] + [blobs[0][:14]] * 3
    elif batch == "overflow":
        blobs[2] = np.zeros(pipe.l_cap + 1, np.uint8)
    assert len({b.size for b in blobs}) > 1
    b = len(blobs)
    out = np.full((b, pipe.l_cap), 0xFF, np.uint8)
    sizes = np.full(b, -1, np.int32)
    if dest == "longer_batch":
        rng = np.random.default_rng(3)
        longer = [rng.integers(1, 256, pipe.l_cap - i, dtype=np.uint8)
                  for i in range(b)]
        pack_into(out, sizes, longer)
        assert out[:, : pipe.l_cap - b].all()
        assert (sizes > pipe.l_cap - b).all()
    if batch == "overflow":
        with pytest.raises(ValueError, match="exceeds pipeline l_cap"):
            pack_into(out, sizes, blobs)
        with pytest.raises(ValueError, match="exceeds pipeline l_cap"):
            pipe.pack_streams(blobs)
        return
    want, want_sizes = _fresh_pack(blobs, pipe.l_cap)
    pack_into(out, sizes, blobs)
    assert np.array_equal(out, want) and np.array_equal(sizes, want_sizes)
    streams, got_sizes = pipe.pack_streams(blobs)
    assert type(streams) is np.ndarray and type(got_sizes) is np.ndarray
    assert streams.dtype == np.uint8 and got_sizes.dtype == np.int32
    assert torch.equal(torch.from_numpy(streams), torch.from_numpy(want))
    assert torch.equal(torch.from_numpy(got_sizes),
                       torch.from_numpy(want_sizes))
