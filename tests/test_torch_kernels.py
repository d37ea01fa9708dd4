"""The port's kernel modules (K1 replay, K2 place+fill, K3 compact, K4
emit, K5 replay with summaries, K6 log-fill, E1 the encoder's field pass)
against the JAX package's Pallas kernels, bit-exact.  On CPU tensors each
wrapper takes its kernel's plain version; the JAX side runs its Pallas
kernels in interpret mode, as the JAX tests do."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoipp_tpu.ops import compact_kernel as jck
from qoipp_tpu.ops import encode as jenc
from qoipp_tpu.ops import emit_kernel as jek
from qoipp_tpu.ops import place_kernel as jpk
from qoipp_tpu.ops import replay_kernel as jrk
from qoipp_tpu_torch import convert
from qoipp_tpu_torch.convert import words_to_numpy
from qoipp_tpu_torch.kernels import selfcheck
from qoipp_tpu_torch.kernels.selfcheck import mixed_pixels
from qoipp_tpu_torch.ops import compact_kernel, emit_kernel, fields_kernel
from qoipp_tpu_torch.ops import place_kernel, replay_kernel
from qoipp_tpu_torch.ops.bitops import hash6

torch.set_num_threads(1)

def words_to_torch(words):
    return convert.words_to_torch(words, device="cpu")


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _np(x):
    return np.asarray(x)


def _chunk_rows(rng, c, b, p_rst):
    """Random (meta, val) rows: every class (and the unused 6, 7), any
    arg, rst bits with probability p_rst."""
    cls = rng.integers(0, 8, (c, b))
    arg = rng.integers(0, 64, (c, b))
    rst = rng.random((c, b)) < p_rst
    meta = (cls | (arg << 3) | (rst.astype(np.int64) << 9)).astype(np.uint32)
    return meta, _words(rng, (c, b))


@pytest.mark.parametrize("seed,p_rst", [(0, 0.0), (1, 0.01)])
def test_replay_batch_carry(seed, p_rst):
    rng = np.random.default_rng(seed)
    c, b = 1024, 8
    meta, val = _chunk_rows(rng, c, b, p_rst)
    prev, seen = _words(rng, (1, b)), _words(rng, (64, b))
    want = jrk.replay_batch_carry(jnp.asarray(meta), jnp.asarray(val),
                                  jnp.asarray(prev), jnp.asarray(seen))
    tprev, tseen = convert.carry_from_jax(prev, seen, device="cpu")
    got = replay_kernel.replay_batch_carry(words_to_torch(meta),
                                           words_to_torch(val), tprev, tseen)
    for w, g in zip(want, got):
        assert np.array_equal(_np(w), words_to_numpy(g))
    # the out-carry continues the replay exactly where the window ended
    jp, js = convert.carry_to_jax(got[1], got[2])
    assert np.array_equal(jp, _np(want[1])) and np.array_equal(js, _np(want[2]))


def test_replay_initial_state_index53():
    # a first chunk OP_INDEX 53 reads the seeded start pixel
    meta = np.zeros((512, 2), np.uint32)
    meta[0] = meta[1] = 4 | (53 << 3)
    meta[2, 1] = 1  # SETA 0 on lane 1, then INDEX 0 reads it back
    meta[3, 1] = 4
    val = np.zeros((512, 2), np.uint32)
    want = jrk.replay_batch(jnp.asarray(meta), jnp.asarray(val))
    got = replay_kernel.replay_batch(words_to_torch(meta), words_to_torch(val))
    assert np.array_equal(_np(want), words_to_numpy(got))
    assert int(words_to_numpy(got)[0, 0]) == 0xFF000000


@pytest.mark.parametrize("seed,p_rst", [(4, 0.0), (5, 0.02)])
def test_replay_emits_repeat_the_last_state_row(seed, p_rst):
    # the identity the kernel's fill relies on: a row that is not a state
    # row (class 1-4, or a reset) emits the emit of the last state row
    # before it in the lane, or prev_in before the first
    rng = np.random.default_rng(seed)
    c, b = 700, 6
    meta, val = _chunk_rows(rng, c, b, p_rst)
    meta[:, 1] = (meta[:, 1] & ~np.uint32(7)) | rng.choice([0, 5, 6, 7], c)
    prev, seen = _words(rng, (1, b)), _words(rng, (64, b))
    emits = words_to_numpy(replay_kernel.replay_batch_carry_reference(
        words_to_torch(meta), words_to_torch(val), words_to_torch(prev),
        words_to_torch(seen))[0])
    cls = meta & 7
    state = ((cls >= 1) & (cls <= 4)) | ((meta >> 9) & 1 == 1)
    assert state.any() and (~state).any()
    for lane in range(b):
        last = prev[0, lane]
        for r in range(c):
            if state[r, lane]:
                last = emits[r, lane]
            else:
                assert emits[r, lane] == last, (lane, r)


# rows (cls, arg, rst) of one lane each, val 0, and the longest chain of
# dependent operations they need: SETA 0, SETC 1, ADD 2 after prev, IDX 1
# after its slot's last writer (ADD of 0 keeps the start pixel, slot 53)
CHAIN_CASES = {
    "setc": ([[(2, 0, 0)] * 3], 3),
    "add": ([[(3, 0, 0)] * 3], 6),
    "seta_restarts": ([[(3, 0, 0), (3, 0, 0), (1, 0, 0), (2, 0, 0)]], 4),
    "nop_run_free": ([[(2, 0, 0), (0, 0, 0), (5, 0, 0), (6, 0, 0),
                       (7, 0, 0), (2, 0, 0)]], 2),
    "idx_reads_its_writer": ([[(3, 0, 0)] * 3 + [(1, 0, 0), (4, 53, 0)]], 7),
    "idx_of_an_older_slot": ([[(3, 0, 0)] * 3 + [(4, 1, 0), (2, 0, 0)]], 6),
    "reset_restarts": ([[(3, 0, 0)] * 3 + [(3, 0, 1), (3, 0, 0)]], 6),
    "longest_lane": ([[(2, 0, 0)] * 2, [(3, 0, 0)] * 2 + [(0, 0, 0)]], 4),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_depth_counts_the_function_dependences(case):
    from qoipp_tpu_torch.benchmarks import replay_probe
    lanes, want = CHAIN_CASES[case]
    c = max(map(len, lanes))
    meta = np.zeros((c, len(lanes)), np.uint32)
    for j, rows in enumerate(lanes):
        for r, (cls, arg, rst) in enumerate(rows):
            meta[r, j] = cls | arg << 3 | rst << 9
    tm = words_to_torch(meta)
    emits = replay_kernel.replay_batch(tm, torch.zeros_like(tm))
    assert replay_probe.chain_depth(tm, emits) == want


def _pix_before(rng, b, q, mean_px):
    """Boundary-pass-shaped offsets: exclusive prefix sums of per-row pixel
    counts (0 on non-start rows, 1..62 on chunk starts)."""
    start = rng.random((b, q)) < 0.6
    start[:, 0] = True
    produced = np.where(start, rng.integers(1, 2 * mean_px, (b, q)), 0)
    produced = np.minimum(produced, 62)
    return (np.cumsum(produced, axis=1) - produced).astype(np.int32)


def _jax_place_fill(pb, emits, n_cap):
    """The JAX K2's whole output; Q padded to 128 rows with pb = n_cap,
    which never write, as its wrapper requires."""
    pad = (-pb.shape[1]) % 128
    pb = np.pad(pb, ((0, 0), (0, pad)), constant_values=n_cap)
    emits = np.pad(emits, ((0, 0), (0, pad)))
    return _np(jpk.place_fill(jnp.asarray(pb), jnp.asarray(emits),
                              jpk.window_base_rows(jnp.asarray(pb), n_cap),
                              n_cap))


def test_place_fill():
    rng = np.random.default_rng(5)
    b, q, n_cap = 4, 1024, 2 * place_kernel.WIN
    pb = np.concatenate([_pix_before(rng, 2, q, 30),  # overflows n_cap
                         _pix_before(rng, 2, q, 4)])  # ends inside it
    emits = _words(rng, (b, q))
    want = _jax_place_fill(pb, emits, n_cap)
    got = place_kernel.place_fill(torch.from_numpy(pb), words_to_torch(emits),
                                  n_cap)
    assert got.shape == (b, n_cap)
    assert (pb[:2, -1] >= n_cap).all() and (pb[2:, -1] < n_cap).all()
    assert np.array_equal(want, words_to_numpy(got))  # the whole output


def _place_case(name, rng):
    """(pb, n_cap) of one K2 edge case, B = 3."""
    win = place_kernel.WIN
    if name == "past_n_cap":  # most rows at pb >= n_cap, runs of 62
        produced = np.where(rng.random((3, 900)) < 0.7, 62, 0)
        n_cap = win
    elif name == "empty_tail":  # images stop after 1, 700 and 9000 pixels
        produced = np.zeros((3, 700), np.int64)
        produced[0, 0], produced[1, :700] = 1, 1
        produced[2, :300] = 30
        n_cap = 5 * win
    elif name == "window_edge":  # 62-pixel runs over each window edge
        produced = rng.integers(0, 3, (3, 3000))
        for i in range(3):
            at = np.searchsorted(np.cumsum(produced[i]), win - 20 * i) - 1
            produced[i, at : at + 3] = 62
        n_cap = 2 * win
    else:  # split lane rows: Q not a multiple of 128, a first pb > 0, a
        # lane whose budget ends early and rows of pb = n_cap after it
        produced = np.where(rng.random((3, 1000)) < 0.5,
                            rng.integers(1, 63, (3, 1000)), 0)
        n_cap = 3 * win
    pb = (np.cumsum(produced, axis=1) - produced).astype(np.int32)
    if name == "lane_rows":
        pb[0] += 100
        pb[2, 600:] = n_cap
    return pb, n_cap


@pytest.mark.parametrize("name", ["past_n_cap", "empty_tail", "window_edge",
                                  "lane_rows"])
def test_place_fill_edge_cases(name):
    rng = np.random.default_rng(len(name))
    pb, n_cap = _place_case(name, rng)
    emits = _words(rng, pb.shape)
    got = place_kernel.place_fill(torch.from_numpy(pb), words_to_torch(emits),
                                  n_cap)
    assert np.array_equal(_jax_place_fill(pb, emits, n_cap),
                          words_to_numpy(got))


def _compact_keep(case, rng, b, n):
    """A keep mask: rows kept with probability ``case``, or lane 0 all kept
    beside an empty lane 1 ("full beside empty"), or lanes toggled in runs
    of 4,096 rows, K3's tile on the card ("tile runs"); lane 2 random."""
    if not isinstance(case, str):
        return rng.random((b, n)) < case
    keep = rng.random((b, n)) < 0.4
    if case == "full beside empty":
        keep[0], keep[1] = True, False
    else:
        run = (np.arange(n) // 4096) % 2 == 0
        keep[0], keep[1] = run, ~run
    return keep


@pytest.mark.parametrize("case", [0.0, 0.03, 0.4, 1.0, "full beside empty",
                                  "tile runs"])
def test_compact_rows(case):
    rng = np.random.default_rng(int(case * 100) if not isinstance(case, str)
                                else len(case))
    b, n = 3, 2 * jck.BLK if not isinstance(case, str) else 4 * 4096
    keep = _compact_keep(case, rng, b, n)
    planes = [_words(rng, (b, n)) for _ in range(2)]
    cap = ((int(keep.sum(axis=1).max()) + jck.BLK + 256) // 128 + 1) * 128
    jplanes = tuple(jnp.asarray(p) for p in planes)
    want, wcounts = jck.compact_rows(jplanes, jnp.asarray(keep), cap=cap)
    ref, rcounts = jck.compact_rows_reference(jplanes, jnp.asarray(keep), cap)
    got, counts = compact_kernel.compact_rows(
        tuple(words_to_torch(p) for p in planes), torch.from_numpy(keep), cap)
    assert np.array_equal(counts.numpy(), _np(wcounts))
    assert np.array_equal(counts.numpy(), _np(rcounts))
    for w, r, g in zip(want, ref, got):
        g = words_to_numpy(g)
        for i in range(b):
            c = int(counts[i])
            assert np.array_equal(g[i, :c], _np(w)[i, :c])
            assert np.array_equal(g[i, :c], _np(r)[i, :c])


def test_compact_rows_past_cap():
    # counts past cap: counts as JAX's, the rows below cap the first cap
    # kept rows (JAX's clamped DMA leaves its rows undefined there)
    rng = np.random.default_rng(21)
    b, n, cap = 3, 4 * jck.BLK, jck.BLK + 128
    keep = rng.random((b, n)) < 0.6
    keep[2] = False
    keep[2, : cap - 5] = True  # a lane under cap beside two over it
    planes = [_words(rng, (b, n)) for _ in range(2)]
    _, wcounts = jck.compact_rows(tuple(jnp.asarray(p) for p in planes),
                                  jnp.asarray(keep), cap=cap)
    got, counts = compact_kernel.compact_rows(
        tuple(words_to_torch(p) for p in planes), torch.from_numpy(keep), cap)
    assert np.array_equal(counts.numpy(), _np(wcounts))
    assert (counts[:2] > cap).all() and counts[2] == cap - 5
    for p, g in zip(planes, got):
        assert g.shape == (b, cap)
        for i in range(b):
            rows = np.flatnonzero(keep[i])[:cap]
            assert np.array_equal(words_to_numpy(g)[i, : rows.size],
                                  p[i, rows])


def _encoder_rows(rng, b, c, all_six_lane):
    """Emit inputs shaped as the encoder builds them: chunk rows of 1..6
    bytes, the 6/2-3/1-byte trailing, marker and sentinel rows at counts,
    zero-byte padding after; templates carry nbytes << 16 in thn."""
    nbytes = np.zeros((b, c), np.int64)
    for i in range(b):
        if i == all_six_lane:
            cnt = c - 3
            nbytes[i, :cnt] = 6
        else:
            cnt = int(rng.integers(c // 2, c - 3))
            nbytes[i, :cnt] = rng.integers(1, 7, cnt)
        nbytes[i, cnt : cnt + 3] = (6, int(rng.integers(2, 4)), 1)
    tlo = _words(rng, (b, c))
    thn = ((_words(rng, (b, c)) & 0xFFFF) | (nbytes << 16)).astype(np.uint32)
    off = (14 + np.cumsum(nbytes, axis=1) - nbytes).astype(np.int32)
    return off, tlo, thn


def test_emit_bytes():
    rng = np.random.default_rng(9)
    b, c, out_cap = 3, 3072, 2 * emit_kernel.WIN
    off, tlo, thn = _encoder_rows(rng, b, c, all_six_lane=2)
    assert off[2].max() > out_cap  # 6-byte rows run past out_cap
    want = jek.emit_bytes(jnp.asarray(off), jnp.asarray(tlo),
                          jnp.asarray(thn),
                          jek.window_base_rows(jnp.asarray(off), out_cap),
                          out_cap)
    got = emit_kernel.emit_bytes(torch.from_numpy(off), words_to_torch(tlo),
                                 words_to_torch(thn), out_cap)
    assert got.dtype == torch.uint8 and got.shape == (b, out_cap)
    assert np.array_equal(_np(want).astype(np.uint8), got.numpy())


@pytest.mark.parametrize("seed,p_rst", [(2, 0.0), (3, 0.02)])
def test_replay_batch_summary(seed, p_rst):
    rng = np.random.default_rng(seed)
    c, b = 1024, 8
    meta, val = _chunk_rows(rng, c, b, p_rst)
    cls = meta & 7
    cls[:, 1] = 4  # an IDX-only lane
    cls[:, 2] = rng.choice([0, 5], c)  # a lane that writes nothing
    meta = (meta & ~np.uint32(7)) | cls
    meta[:, 2] &= ~np.uint32(1 << 9)
    prev, seen = _words(rng, (1, b)), _words(rng, (64, b))
    want = jrk.replay_batch_summary(jnp.asarray(meta), jnp.asarray(val),
                                    jnp.asarray(prev), jnp.asarray(seen))
    tprev, tseen = convert.carry_from_jax(prev, seen, device="cpu")
    got = replay_kernel.replay_batch_summary(
        words_to_torch(meta), words_to_torch(val), tprev, tseen)
    assert len(got) == 5
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(_np(w).view(np.uint32), words_to_numpy(g))
    pupd, swr = got[3].numpy(), got[4].numpy()
    assert pupd[0, 2] == 0 and not swr[:, 2].any()  # lane 2 wrote nothing
    # K1's results are K5's first three
    k1 = replay_kernel.replay_batch_carry(words_to_torch(meta),
                                          words_to_torch(val), tprev, tseen)
    for a, g in zip(k1, got):
        assert torch.equal(a, g)


@pytest.mark.parametrize("summary", [False, True], ids=["K1", "K5"])
def test_replay_one_lane_lane_major(summary):
    # one lane's lane-major view (the transpose of a (1, C) plane) counts as
    # contiguous but keeps its row stride C: the plain versions take it as
    # the batch, split and stream paths hand it over
    rng = np.random.default_rng(6)
    meta, val = _chunk_rows(rng, 1024, 1, 0.01)
    prev, seen = _words(rng, (1, 1)), _words(rng, (64, 1))
    jfn, fn = ((jrk.replay_batch_summary, replay_kernel.replay_batch_summary)
               if summary else
               (jrk.replay_batch_carry, replay_kernel.replay_batch_carry))
    want = jfn(jnp.asarray(meta), jnp.asarray(val), jnp.asarray(prev),
               jnp.asarray(seen))
    tprev, tseen = convert.carry_from_jax(prev, seen, device="cpu")
    tmeta, tval = (words_to_torch(np.ascontiguousarray(x.T)).T
                   for x in (meta, val))
    assert tmeta.is_contiguous() and tmeta.stride() == (1, 1024)
    got = fn(tmeta, tval, tprev, tseen)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert np.array_equal(_np(w).view(np.uint32), words_to_numpy(g))


def _flagged_rows(rng, b, n):
    """Expansion-shaped K6 input: flagged words (bit 31) at gaps of 1..64,
    every other word 0; row 0 has a flag at column 0, the last row none."""
    words = np.zeros((b, n), np.uint32)
    for i in range(b - 1):
        pos = np.cumsum(rng.integers(1, 65, n))
        pos = pos[pos < n]
        words[i, pos] = np.uint32(1 << 31) | (_words(rng, pos.size) >> 1)
    words[0, 0] = np.uint32(1 << 31) | 5
    return words


def test_logfill_batch():
    rng = np.random.default_rng(11)
    b, n = 3, 4 * 4096
    words = _flagged_rows(rng, b, n)
    assert words[0, 0] >> 31 and not words[-1].any()
    want = jrk.logfill_batch(jnp.asarray(words), blk=4096)
    got = replay_kernel.logfill_batch(words_to_torch(words))
    assert np.array_equal(_np(want), words_to_numpy(got))


def test_logfill_batch_flags_63_and_64_apart():
    # flags 63 and 64 words apart across every 4,096-word edge (the JAX
    # kernel's block here, a block of warps of the CUDA kernel)
    rng = np.random.default_rng(13)
    n = 4 * 4096
    words = np.zeros((3, n), np.uint32)
    for e in range(4096, n, 4096):
        for row, cols in enumerate(((e - 1, e + 62), (e - 32, e + 32),
                                    (e - 64, e))):
            words[row, list(cols)] = (np.uint32(1 << 31)
                                      | _words(rng, 2) >> 1)
    want = jrk.logfill_batch(jnp.asarray(words), blk=4096)
    got = replay_kernel.logfill_batch(words_to_torch(words))
    assert np.array_equal(_np(want), words_to_numpy(got))
    # a flag fills 64 words (itself and 63 after), then 0
    assert words_to_numpy(got)[2, 4096 + 63] == words[2, 4096]
    assert words_to_numpy(got)[2, 4096 + 64] == 0


@pytest.mark.parametrize("zero_unflagged", [True, False])
def test_logfill_window_rule(zero_unflagged):
    # the rule csrc/logfill.cu computes: the nearest flagged word in
    # [w - 63, w], else words[w - 63] (0 before the row start)
    rng = np.random.default_rng(12)
    b, n = 4, 3000
    words = _flagged_rows(rng, b, n)
    if not zero_unflagged:
        words = np.where(words >> 31 != 0, words,
                         _words(rng, (b, n)) >> 1).astype(np.uint32)
    want = np.zeros_like(words)
    for i in range(b):
        for w in range(n):
            flagged = [k for k in range(max(w - 63, 0), w + 1)
                       if words[i, k] >> 31]
            want[i, w] = (words[i, flagged[-1]] if flagged
                          else words[i, w - 63] if w >= 63 else 0)
    got = replay_kernel.logfill_batch(words_to_torch(words))
    assert np.array_equal(want, words_to_numpy(got))


def _benchmark_module(name):
    """A module of benchmarks/, loaded by path as its own tests load it."""
    path = Path(__file__).resolve().parent.parent / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("channels", [3, 4])
def test_fields_planes_match_jax_kernel(channels):
    # E1 itself, in interpret mode, on the content classes of its own
    # differential test: 6 rows of 3 blocks, a partial last block
    fk = _benchmark_module("fields_kernel")
    contents = _benchmark_module("test_fields_kernel").contents
    nb = 3 * fk.BLK
    n_px = nb - 777
    imgs = contents(np.random.default_rng(n_px * channels), n_px, channels)
    words = np.zeros((len(imgs), nb), np.uint32)
    for i, im in enumerate(imgs):
        if channels == 3:
            im[:, 3] = 255
        words[i, :n_px] = im.astype(np.uint32) @ (1 << np.arange(0, 32, 8,
                                                             dtype=np.uint32))
    want = fk.encode_fields_planes(jnp.asarray(words), jnp.int32(n_px),
                                   channels)
    got = fields_kernel.encode_fields_planes(
        words_to_torch(words), torch.full((len(imgs),), n_px,
                                          dtype=torch.int32), channels)
    for w, g in zip(want, got):  # tlo, thn, run_out
        assert np.array_equal(_np(w), words_to_numpy(g))


def _seen_after(px, n_px, prev, seen):
    """The encoder's table after n_px pixels, by the sequential rule: a
    pixel that differs from the one before it writes its hash slot."""
    table = seen.copy()
    h = hash6(words_to_torch(px)).numpy()
    for i in range(n_px):
        if px[i] != (px[i - 1] if i else prev):
            table[h[i]] = px[i]
    return table


@pytest.mark.parametrize("channels", [3, 4])
def test_fields_planes_match_encode_fields_with_carries(channels):
    # the plain version against _encode_fields with random carries: prev,
    # run 0..61 (61 entering on a repeat of prev: a flush at position 0)
    # and a carried table, rows of their own n_px
    rng = np.random.default_rng(40 + channels)
    n_pxs = [4416, 4000, 2048, 1, 777]
    b, nb = len(n_pxs), 4416
    px = np.stack([mixed_pixels(rng, nb) for _ in range(b)])
    if channels == 3:
        px |= np.uint32(0xFF000000)
    prev = px[:, 0].copy()
    prev[1:] = _words(rng, b - 1)
    run = rng.integers(0, 62, b)
    run[0] = 61
    seen = _words(rng, (b, 64))
    seen[2, hash6(words_to_torch(px[2, :40])).numpy()] = px[2, :40]
    fields = jax.jit(jenc._encode_fields, static_argnames="channels")
    got = fields_kernel.encode_fields_planes(
        words_to_torch(px), torch.tensor(n_pxs, dtype=torch.int32), channels,
        words_to_torch(prev), torch.from_numpy(run.astype(np.int32)),
        words_to_torch(seen.T))
    tlo, thn, run_out, seen_out = (words_to_numpy(x) for x in got)
    for i, n in enumerate(n_pxs):
        template, nbytes, tail, has_trail = fields(
            jnp.asarray(px[i]), jnp.int32(n), channels=channels,
            carry_prev=jnp.uint32(prev[i]), carry_run=jnp.uint32(run[i]),
            carry_seen=jnp.asarray(seen[i]))
        wlo, whn = jenc._pack_template_planes(template, nbytes)
        assert np.array_equal(tlo[i, :n], _np(wlo)[:n])
        assert np.array_equal(thn[i, :n], _np(whn)[:n])
        assert not tlo[i, n:].any() and not thn[i, n:].any()
        trail = (int(_np(tail)[0]) & 0x3F) + 1 if bool(has_trail) else 0
        assert run_out[i, (n - 1) // fields_kernel.BLK] == trail
        assert np.array_equal(seen_out[:, i],
                              _seen_after(px[i], n, prev[i], seen[i]))


@pytest.mark.parametrize("b,nb", selfcheck.FIELDS_SEGMENT_SHAPES)
def test_fields_selfcheck_edges_are_segment_edges(b, nb):
    # the card check's crafted runs, RUN-62 hits and table slot sit at
    # multiples of fields_edge: that is E1's segment length at this shape
    # on an H100, and every cut into more than one segment gets them
    e = selfcheck.fields_edge("cpu", b, nb)
    seg_tiles, nseg = fields_kernel.segments(b, nb, selfcheck.H100_SMS)
    assert e == seg_tiles * fields_kernel.SEG_TILE
    assert nseg == 1 or nb >= 2 * e + 200
    assert nseg > 1 or e >= nb
