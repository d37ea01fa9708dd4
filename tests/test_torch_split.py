"""The port's split-replay decoder (on CPU: K5, K3 and K2's plain versions)
against qoipp_tpu's SplitDecoder and the native oracle, bit-exact: the
same host plans, the same fixpoint round counts, the same pixels, on the
stream kinds of tests/test_split.py; and the cummax seam propagation
against the JAX package's lax.scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu import Channels, Desc, oracle
from qoipp_tpu.common import write_header
from qoipp_tpu.models import split as jsplit
from qoipp_tpu.ops.bitops import START_PIXEL_PACKED
from qoipp_tpu_torch import convert
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.models import split
from qoipp_tpu_torch.ops import decode as dec_ops
from qoipp_tpu_torch.ops import gather_kernel

torch.set_num_threads(1)

def words_to_torch(words):
    return convert.words_to_torch(words, device="cpu")


def _unpack(px, channels):
    """(N,) uint32 pixel words -> (N * channels,) uint8 pixels, by G1's
    plain version."""
    out = torch.empty(px.size * channels, dtype=torch.uint8)
    gather_kernel.gather_pixels_plain(
        words_to_torch(px), gather_kernel.segment_table(
            [(0, px.size, 0, channels)]), out)
    return out.numpy()


def _mixed_image(rng, w, h, ch):
    """Long runs, palette reuse (INDEX), gradients (DIFF/LUMA) and noise
    (RGB/RGBA): every op class crosses segment seams."""
    n = w * h
    px = rng.integers(0, 256, (n, ch)).astype(np.uint8)
    px[n // 8 : n // 3] = 23
    pal = rng.integers(0, 256, (6, ch)).astype(np.uint8)
    px[n // 3 : n // 2] = pal[rng.integers(0, 6, n // 2 - n // 3)]
    ramp = (np.arange(n // 4) % 250).astype(np.uint8)
    px[n // 2 : n // 2 + n // 4] = ramp[:, None] // np.arange(1, ch + 1)
    return px.reshape(-1)


def _encode(raw, w, h, ch):
    return oracle.encode(raw, Desc(w, h, Channels(ch)))[0]


def _same_plan(got, want):
    (regions, heads, sizes, budgets, where, descs, qb, n_cap, max_chain,
     qc) = got
    assert np.array_equal(regions, want[0])
    assert np.array_equal(heads, want[1])
    assert np.array_equal(sizes, want[2])
    assert np.array_equal(budgets, want[3])
    assert where == want[4]
    assert [(d.width, d.height, int(d.channels)) for d in descs] == [
        (d.width, d.height, int(d.channels)) for d in want[5]]
    assert (qb, n_cap, max_chain, qc) == tuple(want[6:])


def _check(blobs, lanes, wants):
    """Port vs JAX: equal plans and rounds, equal pixels on every lane's
    span; port vs the expected raw pixels of each stream."""
    jdec = jsplit.SplitDecoder(lanes=lanes)
    jplan = jdec.plan_and_pack(blobs)
    jpacked, _, _, jrounds = jdec.dispatch_staged(jdec.stage_plan(jplan))
    dec = split.SplitDecoder(lanes=lanes, device="cpu")
    plan = dec.plan_and_pack(blobs)
    _same_plan(plan, jplan)
    packed, where, descs, rounds = dec.dispatch_staged(dec.stage_plan(plan))
    assert rounds == int(jrounds)
    assert rounds <= plan[8] + 2
    got, jgot = words_to_numpy(packed), np.asarray(jpacked)
    for segs, d, want in zip(where, descs, wants):
        px = np.empty(d.width * d.height, np.uint32)
        for lane, p0, p1 in segs:
            assert np.array_equal(got[lane, : p1 - p0], jgot[lane, : p1 - p0])
            px[p0:p1] = got[lane, : p1 - p0]
        assert np.array_equal(_unpack(px, int(d.channels)), want)
    return plan, rounds


@pytest.mark.parametrize("lanes", [4, 16])
def test_split_single_stream(lanes):
    raw = _mixed_image(np.random.default_rng(0), 320, 200, 3)
    _check([_encode(raw, 320, 200, 3)], lanes, [raw])


def test_split_multi_stream_chains():
    rng = np.random.default_rng(1)
    blobs, raws = [], []
    for w, h, ch in [(300, 150, 3), (128, 128, 4), (64, 32, 3), (250, 99, 4)]:
        raws.append(_mixed_image(rng, w, h, ch))
        blobs.append(_encode(raws[-1], w, h, ch))
    plan, _ = _check(blobs, 24, raws)
    assert plan[1].sum() >= 4  # one chain head per stream


def test_split_run_opening_seams():
    raw = np.full(256 * 128 * 3, 77, np.uint8)
    raw[:3] = (1, 2, 3)
    blob = _encode(raw, 256, 128, 3)
    _check([blob], 8, [raw])
    # the user entry point, end to end
    got = split.SplitDecoder(lanes=8, device="cpu").decode([blob])
    assert np.array_equal(got[0], raw)


def test_split_index_heavy():
    rng = np.random.default_rng(2)
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, 200 * 100)].reshape(-1)
    _check([_encode(raw, 200, 100, 3)], 16, [raw])


def test_split_overproducing_runs_clamp_like_reference():
    # RUNs that produce 3x w*h: the reference clamps at w*h, and so must
    # each lane's pix_before at its segment's budget
    w, h = 100, 10
    desc = Desc(w, h, Channels.RGB)
    body = bytearray()
    rng = np.random.default_rng(7)
    produced = 0
    while produced < 3 * w * h:
        body += bytes([0xFE, *(int(x) for x in rng.integers(0, 256, 3))])
        body += bytes([0xC0 | 61])
        produced += 63
    stream = np.frombuffer(bytes(write_header(desc)) + bytes(body)
                           + b"\0" * 7 + b"\1", np.uint8)
    want = oracle.decode(stream, desc, Channels.RGB)
    _check([stream], 8, [want])


def test_split_chunk_compaction_engages():
    rng = np.random.default_rng(4)
    n = 400 * 300
    raw = np.repeat(rng.integers(0, 256, (n // 8 + 1, 3), dtype=np.uint8),
                    8, axis=0).reshape(-1)[: n * 3].copy()
    blob = _encode(raw, 400, 300, 3)
    plan, _ = _check([blob], 8, [raw])
    assert plan[9] > 0
    # the byte domain gives the same pixels on every lane's span
    dec = split.SplitDecoder(lanes=8, device="cpu")
    packed_c, where, _, _ = dec.dispatch_staged(dec.stage_plan(plan))
    packed_b, _, _, _ = dec.dispatch_staged(dec.stage_plan(plan[:9] + (0,)))
    for lane, a, b in where[0]:
        assert torch.equal(packed_b[lane, : b - a], packed_c[lane, : b - a])


def test_split_dense_stream_gates_to_byte_domain():
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (48, 3)).astype(np.uint8)
    raw = pal[rng.integers(0, 48, 200 * 160)].reshape(-1)
    plan, _ = _check([_encode(raw, 200, 160, 3)], 8, [raw])
    assert plan[9] == 0


def test_split_rejects_more_streams_than_lanes():
    rng = np.random.default_rng(3)
    desc = Desc(32, 24, Channels.RGB)
    blobs = [oracle.encode(rng.integers(0, 256, 32 * 24 * 3, dtype=np.uint8),
                           desc)[0] for _ in range(5)]
    with pytest.raises(ValueError, match="streams > 4 lanes"):
        split.SplitDecoder(lanes=4, device="cpu").plan_and_pack(blobs)
    with pytest.raises(ValueError, match="1..128"):
        split.SplitDecoder(lanes=129, device="cpu")


def _jax_propagate(heads, out_p, out_s, pu, sw):
    """models/split.py's propagate: the lax.scan over lanes."""
    seen0 = jsplit._seen0_vec()

    def step(carry, x):
        p_c, s_c = carry
        head_k, op, os_, pu_k, sw_k = x
        in_p = jnp.where(head_k, jnp.uint32(START_PIXEL_PACKED), p_c)
        in_s = jnp.where(head_k, seen0, s_c)
        return ((jnp.where(pu_k > 0, op, in_p), jnp.where(sw_k > 0, os_, in_s)),
                (in_p, in_s))

    (fin_p, fin_s), (in_p, in_s) = jax.lax.scan(
        step, (jnp.uint32(START_PIXEL_PACKED), seen0),
        (heads, out_p, out_s, pu, sw))
    return (np.asarray(in_p), np.asarray(in_s),
            np.concatenate([np.asarray(fin_p)[None], np.asarray(fin_s)]))


@pytest.mark.parametrize("seed,lanes,p_bit", [(0, 1, 0.5), (1, 24, 0.05),
                                              (2, 96, 0.3), (3, 128, 0.9)])
def test_propagate_matches_jax_scan(seed, lanes, p_bit):
    rng = np.random.default_rng(seed)
    heads = rng.random(lanes) < 0.15
    out_p = rng.integers(0, 1 << 32, lanes, dtype=np.uint64).astype(np.uint32)
    out_s = rng.integers(0, 1 << 32, (lanes, 64),
                         dtype=np.uint64).astype(np.uint32)
    pu = (rng.random(lanes) < p_bit).astype(np.int32)
    sw = (rng.random((lanes, 64)) < p_bit).astype(np.int32)
    want_p, want_s, want_fin = _jax_propagate(
        jnp.asarray(heads), jnp.asarray(out_p), jnp.asarray(out_s),
        jnp.asarray(pu), jnp.asarray(sw))
    got_p, got_s, got_fin = dec_ops.propagate(
        torch.from_numpy(heads), words_to_torch(out_p[None]),
        words_to_torch(out_s.T), torch.from_numpy(pu[None].copy()),
        torch.from_numpy(sw.T.copy()))
    assert np.array_equal(words_to_numpy(got_p)[0], want_p)
    assert np.array_equal(words_to_numpy(got_s).T, want_s)
    assert np.array_equal(words_to_numpy(got_fin), want_fin)


def test_compact_chunks_matches_jax():
    rng = np.random.default_rng(6)
    l, qb, n_cap, qc = 3, 4096, 8192, 4096
    keep = rng.random((l, qb)) < 0.3
    meta = rng.integers(0, 512, (l, qb)).astype(np.uint32)
    val = rng.integers(0, 1 << 32, (l, qb), dtype=np.uint64).astype(np.uint32)
    pb = np.minimum(np.cumsum(keep, axis=1), n_cap).astype(np.int32)
    want = jsplit._compact_chunks(jnp.asarray(meta), jnp.asarray(val),
                                  jnp.asarray(pb), jnp.asarray(keep), n_cap,
                                  qc)
    got = split._compact_chunks(words_to_torch(meta), words_to_torch(val),
                                torch.from_numpy(pb), torch.from_numpy(keep),
                                n_cap, qc)
    counts = keep.sum(axis=1)
    assert np.array_equal(words_to_numpy(got[0]), np.asarray(want[0]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    for i in range(l):  # val rows past the count are unspecified in JAX
        c = counts[i]
        assert np.array_equal(words_to_numpy(got[1])[i, :c],
                              np.asarray(want[1])[i, :c])
        assert not got[1][i, c:].any()


def test_stage_to_device_is_stage_plan_of_plan(monkeypatch):
    rng = np.random.default_rng(4)
    blobs = [_encode(_mixed_image(rng, 96, 64, ch), 96, 64, ch)
             for ch in (3, 4)]
    dec = split.SplitDecoder(lanes=8, device="cpu")
    got = dec.stage_to_device(blobs)
    want = dec.stage_plan(dec.plan_and_pack(blobs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        elif isinstance(g, list) and g and hasattr(g[0], "channels"):
            assert [(d.width, d.height, int(d.channels)) for d in g] == [
                (d.width, d.height, int(d.channels)) for d in w]
        else:
            assert g == w
    calls = []
    staged = dec.stage_to_device
    monkeypatch.setattr(dec, "stage_to_device",
                        lambda b: calls.append(b) or staged(b))
    packed, where, descs, rounds = dec.decode_to_device(blobs)
    assert calls == [blobs]
    assert rounds >= 1 and packed.shape[0] == got[0].shape[0]

