"""The batch encoder's order of stages on the CPU: fields-first
(ops/encode.encode_rows: E1's templates of every pixel, K3 on them, the
emit stage's tail rows, offsets and K4) against the compact-first chain
(selfcheck.encode_compact_first: chunk_positions, K3's plain version on
the pixels, chunk_templates, K4's plain version) and against the JAX
package's encode_batch_checked, whole streams, lengths and ok flags, on
seeded rows built at the encoder's edges, RGB and RGBA; the rows flagged
ok also against the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from qoipp_tpu.ops import encode as jenc

from qoipp_tpu_torch import oracle
from qoipp_tpu_torch.common import Channels, Desc, write_header
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.kernels.selfcheck import mixed_pixels
from qoipp_tpu_torch.ops import encode
from qoipp_tpu_torch.ops.bitops import hash6

torch.set_num_threads(1)

OPAQUE = np.uint32(0xFF000000)


def _streaks(rng, nb):
    # after a break, exactly k pixels equal to the one before them: k = 61
    # flushes nothing, 62 flushes on its last, 63 one past, 124 twice
    rows = []
    for k in (61, 62, 63, 124):
        px = mixed_pixels(rng, nb)
        for s in range(100, nb - 300, 400):
            px[s - 1] = px[s - 2] ^ np.uint32(0x00030201)
            px[s : s + k] = px[s - 1]
            px[s + k] = px[s - 1] ^ np.uint32(0x00050505)
        rows.append(px)
    return np.stack(rows), nb, None


def _trailing(rng, nb):
    # each row ends in a run of 0, 1, 61, 62 or 63 pixels
    px = np.stack([mixed_pixels(rng, nb) for _ in range(5)])
    for i, t in enumerate((0, 1, 61, 62, 63)):
        px[i, nb - t - 2] = px[i, nb - t - 3] ^ np.uint32(0x00010101)
        px[i, nb - t - 1] = px[i, nb - t - 2] ^ np.uint32(0x00020202)
        if t:
            px[i, nb - t :] = px[i, nb - t - 1]
    return px, nb, None


def _short(rng, nb):
    # n_px short of Nb, garbage past it (neither order may read it)
    return np.stack([mixed_pixels(rng, nb) for _ in range(3)]), nb - 517, None


def _single(rng, nb):
    # one pixel: the start pixel itself (a run of 1, no chunk) or another
    px = np.stack([mixed_pixels(rng, 64) for _ in range(2)])
    px[0, 0] = OPAQUE
    px[1, 0] = np.uint32(0xFF102030)
    return px, 1, None


def _index_far(rng, nb):
    # eight words of eight hashes written at the start, then thousands of
    # pixels of other hashes, then hits on those slots
    pal = rng.integers(0, 1 << 24, 64, dtype=np.uint64).astype(np.uint32)
    pal = pal | OPAQUE
    h = hash6(torch.from_numpy(pal.view(np.int32))).numpy()
    _, first = np.unique(h, return_index=True)
    pal, used = pal[first[:8]], set(h[first[:8]].tolist())
    rows = []
    for _ in range(3):
        px = mixed_pixels(rng, nb) | OPAQUE
        px[:64] = pal[rng.integers(0, 8, 64)]
        fill = px[64 : nb - 512]
        bad = np.isin(hash6(torch.from_numpy(fill.view(np.int32))).numpy(),
                      list(used))
        fill[bad] = fill[bad] ^ np.uint32(0x00000001)
        bad = np.isin(hash6(torch.from_numpy(fill.view(np.int32))).numpy(),
                      list(used))
        fill[bad] = fill[bad] ^ np.uint32(0x00000002)
        px[nb - 512 :] = pal[rng.integers(0, 8, 512)]
        rows.append(px)
    return np.stack(rows), nb, None


def _dense_and_flat(rng, nb):
    # a flat row, a mixed row, a noise row and a half-run row
    noise = rng.integers(0, 1 << 32, nb, dtype=np.uint64).astype(np.uint32)
    half = mixed_pixels(rng, nb)
    half[: nb // 2] = half[0]
    return np.stack([np.full(nb, 0xFF336699, np.uint32),
                     mixed_pixels(rng, nb), noise, half]), nb


def _tight_chunks(rng, nb):
    # chunk_cap over the median count: a row of more keeps its first chunk_cap
    px, n_px = _dense_and_flat(rng, nb)
    return px, n_px, selfcheck.tight_caps(_packed(px, 4), n_px)


def _tight_bytes(rng, nb):
    # the default chunk_cap, out_cap under the dense rows' streams
    px, n_px = _dense_and_flat(rng, nb)
    return px, n_px, (None, nb + 777)


def _mixed(rng, nb):
    return np.stack([mixed_pixels(rng, nb) for _ in range(3)]), nb, None


def _alpha_flips(rng, nb):
    px = np.stack([mixed_pixels(rng, nb) for _ in range(2)])
    px[:, 100:900:2] ^= np.uint32(0x80000000)
    px[1, 2000:2100] ^= np.uint32(0x01000000)
    return px, nb, None


CASES = {"mixed": _mixed, "alpha_flips": _alpha_flips,
         "streaks_61_62_63_124": _streaks,
         "trailing_0_1_61_62_63": _trailing, "n_px_short": _short,
         "single_pixel": _single, "index_far_back": _index_far,
         "tight_chunk_cap": _tight_chunks, "tight_out_cap": _tight_bytes}


def _packed(px, channels):
    if channels == 3:
        px = px | OPAQUE
    return torch.from_numpy(px.view(np.int32).copy())


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fields_first_equals_compact_first(case, channels):
    rng = np.random.default_rng(sorted(CASES).index(case) * 10 + channels)
    px, n_px, caps = CASES[case](rng, 8192)
    packed = _packed(px, channels)
    chunk_cap, out_cap = caps or (None, None)
    desc = Desc(n_px, 1, Channels(channels))
    header = torch.from_numpy(
        np.frombuffer(write_header(desc), np.uint8).copy())
    got = encode.encode_batch_checked(packed, n_px, header, channels,
                                      chunk_cap=chunk_cap, out_cap=out_cap)
    want = selfcheck.encode_compact_first(packed, n_px, header, channels,
                                          chunk_cap, out_cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    out, lens, ok = (x.numpy() for x in got)
    jout, jlens, jok = (np.asarray(x) for x in jenc.encode_batch_checked(
        jnp.asarray(packed.numpy().view(np.uint32)), n_px,
        jnp.asarray(header.numpy()), channels, chunk_cap=chunk_cap,
        out_cap=out_cap))
    assert np.array_equal(ok, jok)
    # a row of more chunks than chunk_cap: the JAX K3's clamped DMA leaves
    # its compacted rows undefined, so its bytes are compared with the
    # compact-first chain's alone; every other row, ok or not, whole
    _, keep, _ = selfcheck.chunk_positions(packed, n_px)
    cap, _ = encode.encode_caps(packed.shape[1], channels, chunk_cap)
    whole = keep.sum(dim=1).numpy() <= cap
    assert np.array_equal(lens[whole], jlens[whole])
    assert np.array_equal(out[whole], jout[whole])
    if caps is not None:
        assert not ok.all() and ok.any()
    if case == "tight_chunk_cap":  # K3 dropped chunks of some row
        assert not whole.all()
    raw = packed.numpy()[:, :n_px].view(np.uint8).reshape(-1, n_px, 4)
    for i in np.flatnonzero(ok):
        blob = oracle.encode(np.ascontiguousarray(raw[i, :, :channels]),
                             desc)[0]
        assert int(lens[i]) == blob.size
        assert np.array_equal(out[i, : blob.size], blob)
