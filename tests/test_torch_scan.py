"""The port's scan-fixpoint engine (ops/decode.py: decode_bytes,
scan_replay, expand_pixels, pick_tiles; K5's plain version on the CPU)
against the JAX package's, bit-exact: the whole (n_cap,) output, filled,
and the fixpoint round count, on test_alt_engines' images and on the
adversarial INDEX stream of test_parallel, each also against the oracle.

JAX's decode_bytes does not return its rounds; make_sp_decode with one
rank on its seq axis runs the same loop (the same guess, propagation and
cap) and does, so the rounds are held against it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.ops import boundary as jbnd
from qoipp_tpu.ops import decode as jdec
from qoipp_tpu.parallel import mesh as jmesh
from qoipp_tpu.parallel import sharded as jsharded
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.ops import boundary
from qoipp_tpu_torch.ops import decode as dec_ops
from qoipp_tpu_torch.ops.bitops import pixels_to_packed
from test_alt_engines import images
from torch_parallel_jobs import index_stream

torch.set_num_threads(1)


def _region(blob):
    qb = dec_ops._bucket(blob.size - 14, boundary.BLOCK)
    region = np.zeros(qb + 8, np.uint8)
    region[: blob.size - 14] = blob[14:]
    return region, qb


def _jax_rounds(region, info, qb, s_tiles):
    fields = jax.jit(jdec.classify_dense, static_argnames=("qb",))(
        jnp.asarray(region), qb, info["real"])
    _, _, rounds = jsharded.make_sp_decode(
        jmesh.make_mesh((8, 1)), qb, s_tiles, with_rounds=True)(*fields)
    return int(np.asarray(rounds).max())


def _check(desc, raw, blob):
    """Returns (the port's rounds, the tile count)."""
    region, qb = _region(blob)
    n_px = desc.width * desc.height
    n_cap = dec_ops._bucket(n_px, 128)
    s_tiles = dec_ops.pick_tiles(qb)
    jinfo = jbnd.analyze_region(jnp.asarray(region[:qb]),
                                jnp.int32(blob.size - 22), jnp.int32(n_px))
    want, want_filled = jdec.decode_bytes(
        jnp.asarray(region), jinfo["real"], jinfo["produced"],
        jinfo["pix_before"], jnp.int32(n_px), s_tiles=s_tiles, n_cap=n_cap)

    reg = torch.from_numpy(region)
    info = boundary.analyze_region(reg[:qb], blob.size - 22, n_px)
    got, filled = dec_ops.decode_bytes(reg, info["real"], info["produced"],
                                       info["pix_before"], n_px, s_tiles,
                                       n_cap)
    assert got.shape == (n_cap,)
    assert np.array_equal(words_to_numpy(got), np.asarray(want))
    assert int(filled) == int(want_filled) == n_px
    assert torch.equal(got[:n_px], pixels_to_packed(
        torch.from_numpy(raw), int(desc.channels)))

    meta, val = dec_ops.fields_dense_batch(reg[None], info["real"][None])
    _, rounds = dec_ops.scan_replay(meta[0], val[0], s_tiles)
    assert rounds == _jax_rounds(region, jinfo, qb, s_tiles)
    assert rounds <= s_tiles + 2
    return rounds, s_tiles


@pytest.mark.parametrize("desc,raw,blob", images(), ids=["rgb", "rgba"])
def test_decode_bytes_matches_jax(desc, raw, blob):
    _check(desc, raw, blob)


def test_decode_bytes_adversarial_rounds_match_jax():
    """Every chunk after the prologue is an INDEX into a slot a zero-table
    tile cannot resolve: the fixpoint crosses about a tile a round, within
    the n_tiles + 2 cap, and stays exact."""
    rounds, s_tiles = _check(*index_stream())
    assert s_tiles >= 4 and rounds >= 4


def test_expand_pixels_wraps_like_jax():
    """Random uint32 emits and prevs, so the deltas and the running sum
    wrap 2^32 many times, on a real stream's boundary pass."""
    _, _, blob = images()[1]
    region, qb = _region(blob)
    n_px = 96 * 40
    info = boundary.analyze_region(torch.from_numpy(region[:qb]),
                                   blob.size - 22, n_px)
    rng = np.random.default_rng(9)
    emits, prevs = (rng.integers(0, 1 << 32, qb, dtype=np.uint64).astype(
        np.uint32) for _ in range(2))
    n_cap = dec_ops._bucket(n_px, 128)
    want = jdec.expand_pixels(jnp.asarray(emits), jnp.asarray(prevs),
                              *(jnp.asarray(info[k].numpy()) for k in (
                                  "real", "produced", "pix_before")), n_cap)
    got = dec_ops.expand_pixels(torch.from_numpy(emits.view(np.int32)),
                                torch.from_numpy(prevs.view(np.int32)),
                                info["real"], info["produced"],
                                info["pix_before"], n_cap)
    assert np.array_equal(words_to_numpy(got), np.asarray(want))
    delta = (emits.astype(np.int64) - prevs) % (1 << 32)
    assert delta.sum() > 1 << 40  # the sums wrap


def test_pick_tiles_matches_jax():
    for qb in [*range(128, 70_000, 128), 1 << 20, 3 << 19, 5 << 18,
               (1 << 20) + 128, 1 << 23, 7, 1]:
        assert dec_ops.pick_tiles(qb) == jdec.pick_tiles(qb), qb


def test_decode_bytes_rejects_uneven_tiles():
    region = torch.zeros(256 + 8, dtype=torch.uint8)
    z = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        dec_ops.decode_bytes(region, z.bool(), z, z, 1, 3, 128)
