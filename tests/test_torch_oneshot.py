"""The port's one-shot device codec (on CPU: K1, K3, K4 and K6's plain
versions) against qoipp_tpu.ops.jax_backend and the native oracle,
bit-exact: fill_forward, both expansion engines, decode_single on the
golden, truncated and synthetic inputs, and encode_single."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from qoipp_tpu import Channels as JChannels
from qoipp_tpu import Desc as JDesc
from qoipp_tpu import oracle
from qoipp_tpu.ops import decode as jdec
from qoipp_tpu.ops import fill as jfill
from qoipp_tpu.ops import jax_backend
from qoipp_tpu_torch.common import Channels, Desc
from qoipp_tpu_torch import convert
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.ops import backend, decode, encode, fill
from qoipp_tpu_torch.utils.corpus import make_corpus

torch.set_num_threads(1)

def words_to_torch(words):
    return convert.words_to_torch(words, device="cpu")

DESC3 = Desc(29, 17, Channels.RGB)
DESC4 = Desc(24, 14, Channels.RGBA)


def _jdesc(d):
    return JDesc(d.width, d.height, JChannels(int(d.channels)))


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("seed,bits", [(0, 24), (1, 32), (2, 7)])
def test_fill_forward(seed, bits):
    rng = np.random.default_rng(seed)
    shape = (3, 700)
    a, b = _words(rng, shape), _words(rng, shape)
    part = rng.random(shape) < 0.1
    part[2] = False  # a row with nothing to fill from
    valid = part & (rng.random(shape) < 0.8)
    (wa, wb), wgot, wok = jfill.fill_forward(
        [(jnp.asarray(a), bits), (jnp.asarray(b), 32)], jnp.asarray(part),
        jnp.asarray(valid))
    (ga, gb), got, ok = fill.fill_forward(
        [(words_to_torch(a), bits), (words_to_torch(b), 32)],
        torch.from_numpy(part), torch.from_numpy(valid))
    assert np.array_equal(words_to_numpy(ga), np.asarray(wa))
    assert np.array_equal(words_to_numpy(gb), np.asarray(wb))
    assert np.array_equal(got.numpy(), np.asarray(wgot))
    assert np.array_equal(ok.numpy(), np.asarray(wok))


def _expansion_inputs(rng, b, qb, n_cap, opaque):
    """Boundary-pass-shaped rows: real chunk starts producing 1..62
    pixels, pix_before their exclusive prefix sum (some rows past n_cap),
    emits with alpha 0xFF (opaque) or any alpha."""
    real = rng.random((b, qb)) < 0.6
    real[:, 0] = True
    produced = np.where(real, rng.integers(1, 63, (b, qb)), 0)
    produced[0] = np.where(real[0], 1, 0)  # a lane that ends inside n_cap
    pix_before = (np.cumsum(produced, axis=1) - produced).astype(np.int32)
    emits = _words(rng, (b, qb))
    if opaque:
        emits |= np.uint32(0xFF000000)
    return emits, real, produced.astype(np.int32), pix_before


@pytest.mark.parametrize("opaque", [True, False], ids=["opaque", "general"])
def test_expand_bytes_batch(opaque):
    rng = np.random.default_rng(3 if opaque else 4)
    b, qb, n_cap = 3, 2048, 16384
    emits, real, produced, pix_before = _expansion_inputs(rng, b, qb, n_cap,
                                                          opaque)
    assert (pix_before[1:, -1] >= n_cap).all() and pix_before[0, -1] < n_cap
    want = jdec.expand_bytes_batch(jnp.asarray(emits), jnp.asarray(real),
                                   jnp.asarray(produced),
                                   jnp.asarray(pix_before), n_cap)
    got = decode.expand_bytes_batch(
        words_to_torch(emits), torch.from_numpy(real),
        torch.from_numpy(produced), torch.from_numpy(pix_before), n_cap)
    assert got.shape == (b, n_cap) and got.dtype == torch.int32
    assert np.array_equal(words_to_numpy(got), np.asarray(want))


def _check_decode(blob, desc, dst):
    got = backend.decode_single(blob, desc, dst, device="cpu")
    want = jax_backend.decode_single(blob, _jdesc(desc), JChannels(int(dst)))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, oracle.decode(blob, _jdesc(desc),
                                             JChannels(int(dst))))


@pytest.mark.parametrize("desc,name", [
    (DESC3, "image_qoi_3.bin"), (DESC3, "image_qoi_3_incomplete.bin"),
    (DESC4, "image_qoi_4.bin"), (DESC4, "image_qoi_4_incomplete.bin"),
])
def test_decode_single_fixtures(desc, name):
    blob = load_fixture(name)
    _check_decode(blob, desc, desc.channels)
    other = Channels.RGBA if desc.channels == Channels.RGB else Channels.RGB
    got = backend.decode_single(blob, desc, other, device="cpu")
    assert np.array_equal(got, oracle.decode(blob, _jdesc(desc),
                                             JChannels(int(other))))


@pytest.mark.parametrize("desc,raw,qoi", [
    (DESC3, "image_raw_3.bin", "image_qoi_3.bin"),
    (DESC4, "image_raw_4.bin", "image_qoi_4.bin"),
], ids=["rgb", "rgba"])
def test_encode_single_fixtures(desc, raw, qoi):
    got = backend.encode_single(load_fixture(raw), desc, device="cpu")
    assert np.array_equal(got, load_fixture(qoi))
    want = jax_backend.encode_single(load_fixture(raw), _jdesc(desc))
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_corpus_oneshot(channels):
    desc, raws, blobs = make_corpus(1, 96, 64, seed=channels,
                                    channels=channels)
    _check_decode(blobs[0], desc, desc.channels)
    got = backend.encode_single(raws[0], desc, device="cpu")
    assert np.array_equal(got, blobs[0])
    assert np.array_equal(got, np.asarray(jax_backend.encode_single(
        raws[0], _jdesc(desc))))


def test_decode_single_widens_for_truncated_stream():
    # a stream cut right after its header still owes every pixel: the
    # analysis window widens until zero bytes (INDEX 0) produce them all
    desc, _, blobs = make_corpus(1, 64, 48, seed=9)
    blob = blobs[0][:20]
    _check_decode(blob, desc, Channels.RGB)


def test_encode_single_bucket_matches_jax():
    from qoipp_tpu.ops import encode as jenc

    for n in (1, 63, 64, 65, 1000, 2_088_960, 16_777_216):
        assert encode.bucket_size(n) == jenc.bucket_size(n)
        assert decode._bucket(n) == jdec._bucket(n)
