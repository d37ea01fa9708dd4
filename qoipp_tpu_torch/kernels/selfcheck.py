"""Each CUDA kernel against its plain PyTorch version, on edge cases.

``check(name, device)`` runs kernel ``name``'s wrapper and its plain
version on the same seeded inputs on ``device`` and returns the largest
absolute difference (as uint32 values or bytes) over every case; 0 means
bit-exact.  The cases:

  replay:     the crafted INDEX-53 first chunk, random rows of every class
              with rst bits, a random non-initial carry, a C that is not a
              multiple of the kernel's row group; and C = 3 tiles + 5 rows
              (chunk-major and lane-major): random rows, palette rows
              whose IDX rows read the slots the two rows before wrote, a
              reset mid-tile, ADD-only and state-free lanes;
  place_fill (the whole output): lanes whose offsets run past n_cap (rows
              with pb >= n_cap), lanes that end inside it, a lane whose
              first offset is > 0; and place_fill_cases: 24 windows an
              image over 1.1 M rows (three search rounds), five rows a
              pixel (a window's rows span 20 tiles), an image that stops
              after three windows (an empty tail of 21), chunks of up to
              120 pixels (pixels left to the carry inside windows), 96
              split lanes of 12,289 rows with pb = n_cap after a lane's
              budget;
  compact:    empty, full and random keep masks, one to four planes;
              and every COMPACT_CASES case, each called twice in a row:
              B = 1 and N = 1; N neither a multiple of 16 nor of the tile,
              so lane offsets b * N are not 16-byte aligned; an all-kept
              lane beside an empty one; keep toggled in runs of exactly
              the tile; counts past cap; 2^24 rows over 4,098 tiles;
  emit:       encoder-shaped rows, a lane of 6-byte rows across every
              8192-byte window edge and past out_cap;
  replay_summary: resets mid-lane, IDX-only lanes, lanes that write
              nothing (NOP/RUN only), random rows and a random carry; and
              replay's case of C = 3 tiles + 5 rows;
  logfill:    every LOGFILL_CASES case: rows shorter than 64 words;
              random gaps of 1..64, a flag at column 0, a row with no
              flag, rows that are no multiple of the warp segment; flags
              exactly 63 and 64 words apart across every warp-segment and
              block edge; random unflagged words (where the kernel still
              equals the passes);
  fields:     RGB and RGBA; streaks whose 62nd pixel is the last of a tile
              and of a run_out block or the first of a tile, INDEX hits on
              the carried table only and on pixels three tiles back,
              carried runs of 61 and 30 entering at position 0, n_px
              ending mid-tile and n_px = 1, alpha flips, a one-colour row,
              a ragged last tile, every row with its own n_px and carry;
              and fields_segments at every FIELDS_SEGMENT_SHAPES (B 1, 3
              and 16, one tile to 2^18 pixels), segment edges at every
              multiple of 4,096 pixels: a run over two edges that an
              INDEX hit on a slot written only two segments before ends
              with a flush, RUN-62 hits on the last pixel before an edge
              and on the first after one, n_px at the row's end, inside
              the last segment, before the second segment and 0, random
              non-start carries;
  place_wide, place_fill2, place_fill_narrow, place_variant (E2, E3, E5,
              E6; the whole output): B = 4 and B = 1, Q not a multiple of
              the rows staged per step (nor of 128 for E2 and E5), runs of
              equal pb, rows with pb >= n_cap, a 62-pixel run crossing a
              window edge, an empty tail of three windows, a first pb > 0;
              E2 at every lanes, E5 at ns 1, 2, 4 and 64, E6 at every
              do_dma / do_slabs / n_fill it takes; E2 and E5 also on
              narrow_case at Q = 8,000 and 7,999 (a group inside a
              window's last stripe, the next across the window edge), E2
              also on reach_case at reach 63,
              E6 on reach_case at every n_fill (writers 2^n - 1, 2^n
              and 2^n + 1 apart at every position of a mask word, at
              the windows' first and last pixels); E3 also on every
              FILL2_CASES case: windows whose longest chunk is exactly 8
              and exactly 9, units whose second window has no writer (with
              the first window's last pixel owned and not), runs of units
              with no writer (the inherit chain crosses units, an image's
              first units among them), images whose last unit holds only
              tail rows;
  place_grouped (E4; the whole output): every GROUPED_SHAPES (win, g),
              B = 2 and B = 1; equal-pb runs of 2, 3, 256 and 101 rows (the
              last across the kernel's first tile edge) and of win + 300
              rows, rows with pb >= n_cap, a gap over 63 across a window
              edge inside a step (the fill spans the step) and one across a
              step edge (the carry), an empty tail of several steps; lr_mode
              cnt, dyn and smem there, and every lr_mode with and without
              static_inputs on 1,000 rows, which the timing-only modes'
              fixed range holds;
  emit_window (E7; the whole output): every lanes; C not a multiple of
              lanes, rows of 1-6 bytes and gaps of 7-8, a row across a
              window edge, a run of 20,000 equal-off rows (longer than the
              TPU kernel's lenr slabs at every lanes), rows at and past
              out_cap; and every EMIT_RUN_CASES case, images whose last
              3,000 or more rows share one offset (the kernel reads only
              the rows before such a trailing run and its last row): the
              run mid-window, at a window's first byte, at one of its last
              5 bytes (the run's last row crosses the edge), at and past
              out_cap (it writes nothing), with C ragged and odd (scalar
              loads), and beside an interior run of 3,000 rows (its last
              row emits the 4 bytes up to the trailing run) or after one
              of 2,500;
  chunk_starts (the chunk-start scan; the whole output): the two-level
              experiment's byte soup (every length class, tags in the
              payloads) at every
              CHUNK_STARTS_SHAPES (one 128-byte block, a tile of the
              kernel, a tile and a block: a warp that ends inside the
              row, 70 tiles: look-back steps of 32 tiles), rows of one
              tag alone (every byte a start, LUMA, RGB and RGBA chains
              across every tile), RGBA tags with a 1-byte tag every
              seventh byte, and views of wider planes whose rows are 16-,
              8-, 4- and 1-byte aligned (the stream window's (L, qb + 8)
              planes among them);
  gather_pixels (G1; the whole output, a sentinel around the segments):
              every GATHER_CASES case: RGB and RGBA segments from every
              source word alignment to every output byte alignment (16-,
              4- and 1-byte stores), of 1-5 pixels, one pixel short of,
              at and past a tile, and of several tiles; a segment that
              ends at the source's last word where the word count is no
              multiple of 4; 300 segments of a split group's shape (the
              block's search over many rows);
  grid_step (E8): random words and 0xFFFFFFFF, which wraps to 0;
  onehot_place (E9, to TOLERANCE): unsorted targets, a bin hit 64 times,
              targets outside the bins, K not a multiple of the block.

``batch_encode_err`` holds the batch encoder (fields-first: E1, K3, K4)
against ``encode_compact_first``, the compact-first chain in plain
versions (its stages ``chunk_positions``, ``chunk_table`` and
``chunk_templates`` are here too: no encoder runs them), on the inputs
a caller gives it, at the default caps or at ``tight_caps``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import (boundary, compact_kernel, emit_kernel, emit_window,
                   encode, fields_kernel, gather_kernel, place_kernel,
                   place_window, probes, replay_kernel)
from ..ops.bitops import START_PIXEL_PACKED, hash6

REPLAY_TILE = 1024  # rows a tile of csrc/replay.cu (kTile)
# (B, Nb) of fields_segments: one tile to 2^18 pixels at B 1, 3 and 16
FIELDS_SEGMENT_SHAPES = ((1, 1024), (1, 3 * 1024 + 64), (1, 1 << 18),
                         (3, 1024), (3, 1 << 16), (16, 5 * 1024 + 64),
                         (16, 1 << 16))
H100_SMS = 132  # the SM count fields_segments assumes off the card
# largest |kernel - plain| each kernel may show (0 where not listed): E9's
# float32 sums, for the order in which duplicates add
TOLERANCE = {"onehot_place": 1e-6}


def _t(a, device):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| reading int32 words as uint32 values."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    mask = 0xFFFFFFFF if a.dtype == torch.int32 else 0xFF
    d = (a.to(torch.int64) & mask) - (b.to(torch.int64) & mask)
    return int(d.abs().max())


def _replay(device) -> int:
    rng = np.random.default_rng(1)
    err = 0
    # crafted: a first chunk OP_INDEX 53 reads the seeded start pixel
    meta = np.zeros((64, 3), np.uint32)
    meta[0] = 4 | (53 << 3)
    meta[1:, 1] = 1  # then SETA rows on lane 1
    val = _words(rng, (64, 3))
    m, v = _t(meta, device), _t(val, device)
    err = max(err, max_abs_err(
        replay_kernel.replay_batch(m, v),
        replay_kernel.replay_batch_carry_reference(
            m, v, *replay_kernel.initial_state(3, device))[0]))
    # random rows of every class (6 and 7 included), rst bits, random carry
    c, b = 1029, 40
    cls = rng.integers(0, 8, (c, b))
    arg = rng.integers(0, 64, (c, b))
    rst = (rng.random((c, b)) < 0.01).astype(np.int64)
    meta = (cls | (arg << 3) | (rst << 9)).astype(np.uint32)
    args = [_t(x, device) for x in (meta, _words(rng, (c, b)),
                                    _words(rng, (1, b)), _words(rng, (64, b)))]
    got = replay_kernel.replay_batch_carry(*args)
    want = replay_kernel.replay_batch_carry_reference(*args)
    err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
    return max(err, _replay_tiles(replay_kernel.replay_batch_carry,
                                  replay_kernel.replay_batch_carry_reference,
                                  rng, device))


def _replay_tiles(fn, ref, rng, device) -> int:
    """C = 3 tiles + 5 rows of the kernel, chunk-major and lane-major:
    random rows; a lane of SETA/SETC/ADD/IDX rows over a four-pixel
    palette whose IDX rows read the palette's slots, so that an IDX row
    often reads the slot one of the two rows before it wrote (the
    kernel's forwarded writes); a NOP lane with one reset mid-tile; an
    ADD-only lane; a lane of classes 0 and 5-7 only."""
    c, b = 3 * REPLAY_TILE + 5, 5
    cls = rng.integers(0, 8, (c, b))
    arg = rng.integers(0, 64, (c, b))
    rst = (rng.random((c, b)) < 0.001).astype(np.int64)
    val = _words(rng, (c, b))
    pal = _words(rng, 4)
    slots = hash6(_t(pal, "cpu")).numpy()
    cls[:, 1] = rng.choice([1, 2, 3, 4, 4, 4], c)
    arg[:, 1] = rng.choice(np.append(slots, 53), c)
    val[:, 1] = np.where(cls[:, 1] == 3, 0, pal[rng.integers(0, 4, c)])
    cls[:, 2] = 0
    cls[:, 3] = 3
    cls[:, 4] = rng.choice([0, 5, 6, 7], c)
    rst[:, 2:] = 0
    rst[REPLAY_TILE + 1000, 2] = 1
    meta = (cls | (arg << 3) | (rst << 9)).astype(np.uint32)
    args = [_t(x, device) for x in (meta, val, _words(rng, (1, b)),
                                    _words(rng, (64, b)))]
    want = ref(*args)
    lane_major = [x.T.contiguous().T for x in args[:2]] + args[2:]
    return max(max_abs_err(g, w) for rows in (args, lane_major)
               for g, w in zip(fn(*rows), want))


def _place_fill(device) -> int:
    rng = np.random.default_rng(2)
    b, q, n_cap = 5, 4096, 2 * place_kernel.WIN
    start = rng.random((b, q)) < 0.6
    start[:, 0] = True
    scale = np.array([60, 60, 8, 3, 8])[:, None]  # lanes 0-1 pass n_cap
    produced = np.where(start, np.minimum(rng.integers(1, 62, (b, q)),
                                          scale), 0)
    pb = np.cumsum(produced, axis=1) - produced
    pb[4] += 100  # pixels before the first offset read 0
    args = (_t(pb.astype(np.int32), device), _t(_words(rng, (b, q)), device))
    err = max_abs_err(place_kernel.place_fill(*args, n_cap),
                      place_kernel.place_fill_reference(*args, n_cap))
    return max([err] + [max_abs_err(place_kernel.place_fill(pb, em, n_cap),
                                    place_kernel.place_fill_reference(
                                        pb, em, n_cap))
                        for pb, em, n_cap in place_fill_cases(rng, device)])


def place_fill_cases(rng, device):
    """[(pb, emits, n_cap)] of K2 across many blocks: B = 3 images of 24
    windows over 1.1 M rows (image 0 five rows a pixel, past n_cap; image
    1 stops after three windows; image 2 chunks of up to 120 pixels, so
    pixels 64 and on of a chunk take the carry), and 96 split lanes of
    12,289 rows over 3 windows (a first pb > 0 in lane 0, runs of 62, and
    pb = n_cap after each lane's budget)."""
    win = place_kernel.WIN
    q, n_cap = 1_100_000, 24 * win
    produced = np.zeros((3, q), np.int64)
    produced[0, ::5] = 1
    produced[1, :400] = 62
    produced[2] = np.where(rng.random(q) < 0.05, rng.integers(1, 121, q), 0)
    pb = np.cumsum(produced, axis=1) - produced
    cases = [(pb, n_cap)]
    lanes, q = 96, 12_289
    produced = np.where(rng.random((lanes, q)) < 0.5,
                        rng.integers(1, 63, (lanes, q)), 0)
    produced[1::7, ::3] = 62
    pb = np.cumsum(produced, axis=1) - produced
    pb[0] += 100
    n_cap = 3 * win
    budget = rng.integers(0, n_cap, lanes)
    pb = np.where(pb < budget[:, None], pb, n_cap)
    cases.append((pb, n_cap))
    return [(_t(p.astype(np.int32), device), _t(_words(rng, p.shape), device),
             n) for p, n in cases]


COMPACT_CASES = ("one row", "ragged lanes", "full beside empty",
                 "tile runs", "past cap", "2^24 rows")


def compact_case(name: str, rng, device):
    """(planes, keep, cap) of K3 case ``name`` of COMPACT_CASES."""
    tile = compact_kernel.launch_shape()[0]
    b, n, nplanes = {"one row": (1, 1, 1),
                     "ragged lanes": (3, 3 * tile + 9, 2),
                     "full beside empty": (2, 2 * tile + 100, 3),
                     "tile runs": (2, 6 * tile + 11, 4),
                     "past cap": (3, 5 * tile + 3, 2),
                     "2^24 rows": (2, (1 << 23) + 5, 2)}[name]
    cap = {"one row": 4, "past cap": 3000}.get(name, n)
    if name == "one row":
        keep = np.ones((b, n), bool)
    elif name == "full beside empty":
        keep = np.zeros((b, n), bool)
        keep[0] = True
    elif name == "tile runs":
        run = (np.arange(n) // tile) % 2 == 0
        keep = np.stack([run, ~run])
    else:
        keep = rng.random((b, n)) < {"past cap": 0.5, "2^24 rows": 0.1}.get(
            name, 0.3)
    planes = tuple(_t(_words(rng, (b, n)), device) for _ in range(nplanes))
    return planes, _t(keep, device), cap


def compact_err(planes, keep, cap: int) -> int:
    """Max |kernel - plain| of K3 over counts and the rows below both
    counts and cap (rows past counts are unspecified)."""
    got, counts = compact_kernel.compact_rows(planes, keep, cap)
    want, wcounts = compact_kernel.compact_rows_reference(planes, keep, cap)
    err = max_abs_err(counts, wcounts)
    live = torch.arange(cap, device=keep.device)[None, :] < counts[:, None]
    for g, w in zip(got, want):
        err = max(err, max_abs_err(torch.where(live, g, 0),
                                   torch.where(live, w, 0)))
    return err


def _compact(device) -> int:
    rng = np.random.default_rng(3)
    err = 0
    b, n, cap = 3, 5000, 5120
    for nplanes, keep in ((2, np.zeros((b, n), bool)),
                          (1, np.ones((b, n), bool)),
                          (3, rng.random((b, n)) < 0.3),
                          (4, rng.random((b, n)) < 0.9)):
        planes = tuple(_t(_words(rng, (b, n)), device) for _ in range(nplanes))
        err = max(err, compact_err(planes, _t(keep, device), cap))
    for name in COMPACT_CASES:
        case = compact_case(name, rng, device)
        err = max(err, compact_err(*case), compact_err(*case))
    return err


def _emit(device) -> int:
    rng = np.random.default_rng(4)
    b, c, out_cap = 4, 6000, 4 * emit_kernel.WIN
    nbytes = np.zeros((b, c), np.int64)
    for i in range(b):
        cnt = c - 3 if i == 0 else int(rng.integers(c // 4, c - 3))
        nbytes[i, :cnt] = 6 if i == 0 else rng.integers(1, 7, cnt)
        nbytes[i, cnt : cnt + 3] = (6, int(rng.integers(2, 4)), 1)
    off = (14 + np.cumsum(nbytes, axis=1) - nbytes).astype(np.int32)
    thn = (_words(rng, (b, c)) & 0xFFFF) | (nbytes << 16)
    args = (_t(off, device), _t(_words(rng, (b, c)), device),
            _t(thn.astype(np.uint32), device))
    return max_abs_err(emit_kernel.emit_bytes(*args, out_cap),
                       emit_kernel.emit_bytes_reference(*args, out_cap))


def _replay_summary(device) -> int:
    rng = np.random.default_rng(5)
    c, b = 1029, 40
    cls = rng.integers(0, 8, (c, b))
    cls[:, 1] = 4  # IDX-only lane
    cls[:, 2] = rng.choice([0, 5], c)  # lanes that write nothing
    cls[:, 3] = rng.choice([0, 5], c)
    arg = rng.integers(0, 64, (c, b))
    rst = (rng.random((c, b)) < 0.01).astype(np.int64)
    rst[:, 2] = 0
    rst[:, 3] = 0
    rst[c // 2, 3] = 1  # ... except one reset mid-lane
    rst[c // 3, 4] = 1
    meta = (cls | (arg << 3) | (rst << 9)).astype(np.uint32)
    args = [_t(x, device) for x in (meta, _words(rng, (c, b)),
                                    _words(rng, (1, b)), _words(rng, (64, b)))]
    got = replay_kernel.replay_batch_summary(*args)
    want = replay_kernel.replay_batch_summary_reference(*args)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    return max(err, _replay_tiles(
        replay_kernel.replay_batch_summary,
        replay_kernel.replay_batch_summary_reference, rng, device))


LOGFILL_CASES = ("short rows", "random gaps", "flags 63 and 64 apart",
                 "unflagged words")


def logfill_case(name: str, rng):
    """(B, n) uint32 words of K6 case ``name`` of LOGFILL_CASES."""
    seg = replay_kernel.LOGFILL_SEGMENT
    blk = seg * replay_kernel.LOGFILL_WARPS
    flag = np.uint32(1 << 31)
    if name == "short rows":
        words = np.zeros((3, 40), np.uint32)
        words[0, [0, 5, 39]] = flag | np.uint32(3)
        words[1, 30] = flag | np.uint32(4)
        return words
    if name == "flags 63 and 64 apart":
        # around every segment edge e: flags 63 apart (e - 1, e + 62) and
        # 64 apart (e - 32, e + 32, and e - 64, e) across the edge, and a
        # lone flag at e whose reach ends at e + 63
        n = 3 * blk + 2 * seg + 5
        words = np.zeros((4, n), np.uint32)
        for e in range(seg, n, seg):
            for row, cols in enumerate(((e - 1, e + 62), (e - 32, e + 32),
                                        (e - 64, e), (e,))):
                cols = [c for c in cols if c < n]
                words[row, cols] = flag | _words(rng, len(cols)) >> 1
        return words
    n = 3 * blk + 77  # no multiple of the segment
    words = np.zeros((6, n), np.uint32)
    if name == "unflagged words":
        words = _words(rng, (6, n))  # about half of them flagged
        words[1] &= ~flag  # a row with no flag
        words[2] &= ~flag
        words[2, ::97] |= flag  # flags 97 apart over non-zero words
        return words
    for i in range(2):  # random gaps of 1..64
        pos = np.cumsum(rng.integers(1, 65, n))
        pos = pos[pos < n]
        words[i, pos] = flag | _words(rng, pos.size)
    words[2, [0, 63, 127, 192, blk - 1, blk + 62, 2 * blk]] = flag | 7
    words[3, [blk - 5, blk + 58, 2 * blk + 1, 3 * blk - 1]] = flag | 9
    # row 4 has no flag
    words[5, ::seg] = flag | 11
    return words


def _logfill(device) -> int:
    rng = np.random.default_rng(6)
    err = 0
    for name in LOGFILL_CASES:
        words = logfill_case(name, rng)
        for w in (words, words[:, : replay_kernel.LOGFILL_SEGMENT]):
            tw = _t(w, device)
            err = max(err, max_abs_err(
                replay_kernel.logfill_batch(tw),
                replay_kernel.logfill_batch_reference(tw)))
    return err


def mixed_pixels(rng, n):
    """(n,) uint32 pixel words of every op class: runs of 1..200 equal
    pixels, a 6-colour palette (INDEX), small and wrapping deltas
    (DIFF/LUMA), noise (RGB), with rare alpha changes."""
    out = np.empty(n, np.uint32)
    pal = _words(rng, 6) | np.uint32(0xFF000000)
    cur = np.uint32(0xFF000000)
    i = 0
    while i < n:
        kind = rng.integers(0, 5)
        ln = int(rng.integers(1, 200)) if kind == 0 else 1
        if kind == 1:
            cur = pal[rng.integers(0, 6)]
        elif kind == 2:
            d = rng.integers(-3, 3, 3) & 0xFF
            c = [(int(cur) >> (8 * k)) & 0xFF for k in range(4)]
            c[:3] = [(c[k] + int(d[k])) & 0xFF for k in range(3)]
            cur = np.uint32(c[0] | c[1] << 8 | c[2] << 16 | c[3] << 24)
        elif kind == 3:
            cur = _words(rng, 1)[0] | np.uint32(0xFF000000)
        if rng.random() < 0.02:
            cur = (cur & np.uint32(0xFFFFFF)) | np.uint32(
                int(rng.integers(0, 256)) << 24)
        out[i : i + ln] = cur
        i += ln
    return out


def _fields(device) -> int:
    rng = np.random.default_rng(7)
    tile, blk = 1024, fields_kernel.BLK  # csrc/fields.cu kThreads, run_out
    b, nb = 8, 5 * tile + 64  # a ragged last tile and run_out block
    px = np.stack([mixed_pixels(rng, nb) for _ in range(b)])
    n_px = np.full(b, nb, np.int64)
    prev = _words(rng, b) | np.uint32(0xFF000000)
    run = rng.integers(0, 62, b)
    seen = _words(rng, (64, b))
    # row 0: streaks reaching 62 on the last pixel of a tile and on the
    # first pixel of the next tile, and across a run_out block edge
    for start in (tile - 62, blk - 63, 3 * tile - 62):
        px[0, start : start + 130] = px[0, start - 1] ^ np.uint32(0x10101)
    # row 1: words held only by the carried table (slots the row has not
    # written yet), then, after a run through two tiles, hits on pixels of
    # the first tile
    pal = _words(rng, 8)
    seen[hash6(_t(pal, "cpu")).numpy(), 1] = pal
    px[1, :64] = pal[rng.integers(0, 8, 64)]
    px[1, 64:124] = _words(rng, 60)
    px[1, 124 : 3 * tile] = px[1, 123]
    hits = np.arange(3 * tile + 5, nb, 37)
    px[1, hits] = px[1, 64 + np.arange(hits.size) % 60]
    # rows 2-3: a carried run entering at position 0: 61 (flush at 0) and 30
    for row, r in ((2, 61), (3, 30)):
        run[row] = r
        px[row, :90] = prev[row]
    # rows 4-5: n_px ending mid-tile, and a single pixel
    n_px[4], n_px[5] = 2 * tile + 517, 1
    # row 6: alpha flips on every other pixel of a stretch
    px[6, 100:400:2] ^= np.uint32(0x80000000)
    # row 7: a row of one colour (one long run through every tile)
    px[7] = prev[7]
    args = [_t(x, device) for x in (px, n_px.astype(np.int32), prev,
                                    run.astype(np.int32), seen)]
    err = max(_fields_err(args, channels) for channels in (3, 4))
    return max([err] + [fields_segments(device, b, nb)
                        for b, nb in FIELDS_SEGMENT_SHAPES])


def _fields_err(args, channels) -> int:
    got = fields_kernel.encode_fields_planes(args[0], args[1], channels,
                                             *args[2:])
    want = fields_kernel.encode_fields_planes_reference(
        args[0], args[1], channels, *args[2:])
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def fields_edge(device, b: int, nb: int) -> int:
    """The pixels a segment of E1's cut of B rows of nb pixels
    (fields_kernel.segments) on the card of ``device``; off the card, on
    an H100's H100_SMS SMs."""
    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    return fields_kernel.segments(b, nb, sms)[0] * fields_kernel.SEG_TILE


def fields_segments(device, b: int, nb: int) -> int:
    """Max |E1 - plain| (RGB and RGBA) on B rows of nb pixels built around
    the segment edges of E1's cut on this card (fields_edge, e pixels
    apart): pixel 99 a fresh word
    P, then one colour over the first two edges, then P again (an INDEX
    hit on a slot last written two segments back, after a flush); at each
    later edge, a streak whose 62nd pixel is the last before the edge or
    the first after it, in turn.  n_px: the whole row, 517 short of it,
    before the second segment, and 0, in turn; random non-start carries."""
    rng = np.random.default_rng(b * 7 + nb)
    e = fields_edge(device, b, nb)
    px = np.stack([mixed_pixels(rng, nb) for _ in range(b)])
    if nb >= 2 * e + 200:
        for i in range(b):
            p = _words(rng, 1)[0] | np.uint32(0xFF000000)
            c = p ^ np.uint32(0x00010203)
            while int(hash6(_t(np.array([c, p]), "cpu")).unique().numel()) < 2:
                c = c ^ np.uint32(0x00000100)
            px[i, 99] = p
            px[i, 100 : 2 * e + 5] = c
            px[i, 2 * e + 5] = p
        for j, at in enumerate(range(3 * e, nb - 200, e)):
            s = at - 62 if j % 2 == 0 else at - 61  # the 62nd at at-1 or at
            px[:, s - 1] = px[:, s - 2] ^ np.uint32(0x00030201)  # a break
            px[:, s : s + 62] = px[:, s - 1 : s]
            px[:, s + 62] = px[:, s - 1] ^ np.uint32(0x00050505)
    n_px = np.array([[nb, nb - 517, e - 300, 0][i % 4] for i in range(b)])
    args = [_t(x, device) for x in (
        px, np.clip(n_px, 0, nb).astype(np.int32),
        _words(rng, b) | np.uint32(0xFF000000),
        rng.integers(0, 62, b).astype(np.int32), _words(rng, (64, b)))]
    return max(_fields_err(args, channels) for channels in (3, 4))


# ---------------------------------------------------------------------------
# The batch encoder's compact-first reference: the JAX package's
# _encode_kernel_impl, stage by stage, in plain torch.  A dense pass marks
# the chunk rows (differing pixels and RUN-62 flush points), K3 compacts
# the pixels, and the templates are made on the compacted rows.
# ---------------------------------------------------------------------------


def chunk_positions(packed, n_px: int):
    """Compact-first stage 1.  packed (B, Nb) int32 -> (posflag, keep,
    fb): keep marks chunk rows (differing pixels and RUN-62 flush points);
    posflag holds the position with bit fb set on differing pixels."""
    b, nb = packed.shape
    idx = torch.arange(nb, dtype=torch.int32,
                       device=packed.device).expand(b, nb)
    valid = idx < n_px
    prev = torch.cat(
        [torch.full((b, 1), START_PIXEL_PACKED, dtype=torch.int32,
                    device=packed.device), packed[:, :-1]], dim=1)
    eq_raw = packed == prev
    noneq = valid & ~eq_raw
    last_noneq = torch.cummax(torch.where(noneq, idx, -1), dim=1).values
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)  # run-limit flush (RUN 62)
    keep = noneq | hit62
    fb = 21 if nb <= 1 << 21 else 30
    posflag = idx | (noneq.to(torch.int32) << fb)
    return posflag, keep, fb


def chunk_table(pk_c, pf_c, counts, fb: int):
    """chunk_templates' table scan: each compacted chunk row's same-hash
    predecessor word (_last_same_hash_value over the differing rows)."""
    rows = torch.arange(pk_c.shape[1], dtype=torch.int32,
                        device=pk_c.device)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = torch.where(valid_c, pk_c, 0)
    nq_c = valid_c & (((pf_c >> fb) & 1) == 1)
    return encode._last_same_hash_value(pk_c, hash6(pk_c), nq_c)


def chunk_templates(pk_c, pf_c, counts, n_px: int, fb: int, channels: int,
                    table_val=None):
    """Compact-first stage 3.  Compacted chunk rows (pixel, position|flag),
    (B, chunk_cap) int32, and their counts -> (off, tlo, thn, total_len):
    per-row byte offsets and 6-byte templates (thn bits 16+ hold the byte
    count), with the trailing run, end marker and sentinel rows of
    encode.stream_offsets, and each stream's length.  The same-hash scan
    runs here unless table_val, chunk_table's result, is given (a stage
    profile times the scan on its own)."""
    b, chunk_cap = pk_c.shape
    dev = pk_c.device
    rows = torch.arange(chunk_cap, dtype=torch.int32, device=dev)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = torch.where(valid_c, pk_c, 0)
    pf_c = torch.where(valid_c, pf_c, 0)
    pos = pf_c & ((1 << fb) - 1)
    nq_c = valid_c & (((pf_c >> fb) & 1) == 1)

    # a chunk's prev pixel is the previous chunk row's pixel (run interiors
    # repeat it); the pending run length is the position gap
    prev_c = torch.cat([torch.full((b, 1), START_PIXEL_PACKED,
                                   dtype=torch.int32, device=dev),
                        pk_c[:, :-1]], dim=1)
    pos_prev = torch.cat([torch.full((b, 1), -1, dtype=torch.int32,
                                     device=dev), pos[:, :-1]], dim=1)
    gap = torch.where(valid_c, pos - pos_prev - 1, 0)

    h = hash6(pk_c)
    if table_val is None:
        table_val = encode._last_same_hash_value(pk_c, h, nq_c)
    own_len, own = encode.op_bytes(pk_c, prev_c, nq_c, table_val, h,
                                   channels)

    # a differing chunk flushes its pending run first (gap in [1, 61]); a
    # flush row IS the run (RUN 62: 61 equal pixels strictly before it)
    run_byte = torch.where(nq_c, encode.TAG_RUN | ((gap - 1) & 0x3F),
                           encode.TAG_RUN | 61)
    has_run = torch.where(nq_c, gap > 0, valid_c)
    tlo, thn = encode.pack_templates(own_len, own, has_run, run_byte)

    last_pos = torch.where(valid_c, pos, -1).amax(dim=1)
    off, _, total_len = encode.stream_offsets(
        tlo, thn, counts, 14, (n_px - 1 - last_pos).clamp(min=0))
    return off, tlo, thn, total_len


def encode_compact_first(packed, n_px: int, header, channels: int,
                         chunk_cap: int | None = None,
                         out_cap: int | None = None):
    """The batch encoder's reference on the card, where the JAX package
    cannot run: the compact-first stages in plain versions
    (chunk_positions, K3's plain version on the pixels, chunk_templates,
    K4's plain version) -> (out, total_len, ok) as encode_batch_checked
    returns them."""
    chunk_cap, out_cap = encode.encode_caps(packed.shape[1], channels,
                                            chunk_cap, out_cap)
    posflag, keep, fb = chunk_positions(packed, n_px)
    (pk_c, pf_c), counts = compact_kernel.compact_rows_reference(
        (packed, posflag), keep, chunk_cap)
    off, tlo, thn, total_len = chunk_templates(pk_c, pf_c, counts, n_px, fb,
                                               channels)
    out = emit_kernel.emit_bytes_reference(off, tlo, thn, out_cap)
    out[:, :14] = header
    col = torch.arange(out_cap, device=out.device)[None, :]
    out = torch.where(col < total_len[:, None], out, 0)
    ok = (counts + compact_kernel.BLK + 128 <= chunk_cap) & (
        total_len <= out_cap)
    return out, total_len, ok


def tight_caps(packed, n_px: int):
    """(chunk_cap, out_cap) under which some rows of packed are flagged
    not ok: chunk_cap the ok rule's margin over the rows' median chunk
    count, so rows up to the median pass and rows of more chunks than
    chunk_cap keep their first chunk_cap (K3 drops the rest); out_cap Nb
    + 777 bytes, under the streams of dense images."""
    _, keep, _ = chunk_positions(packed, n_px)
    return (int(keep.sum(dim=1).median()) + compact_kernel.BLK + 128,
            packed.shape[1] + 777)


def batch_encode_err(packed, n_px: int, channels: int,
                     chunk_cap: int | None = None,
                     out_cap: int | None = None) -> int:
    """Max |fields-first - compact-first| over the streams, lengths and ok
    flags of the batch encoder (encode_batch_checked: E1, K3 and K4 on
    the card) and encode_compact_first on B rows of packed pixel words,
    n_px valid a row, at the given caps (None: the defaults)."""
    header = torch.arange(1, 15, dtype=torch.uint8, device=packed.device)
    got = encode.encode_batch_checked(packed, n_px, header, channels,
                                      chunk_cap=chunk_cap, out_cap=out_cap)
    want = encode_compact_first(packed, n_px, header, channels, chunk_cap,
                                out_cap)
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def _window_cases(rng, q, device):
    """(pb, emits, n_cap) tensors of the windowed placement's edge cases:
    B = 4 at n_cap = 4 WIN (image 0 runs past n_cap, image 1 leaves a tail
    of three empty windows, image 2 has a 62-pixel run over the first
    window edge, image 3 starts at pixel 100 with long runs of equal pb),
    and B = 1 at n_cap = 2 WIN."""
    win = place_kernel.WIN
    produced = np.zeros((4, q), np.int64)
    start = rng.random((4, q))
    produced[0] = np.where(start[0] < 0.6, rng.integers(1, 40, q), 0)
    produced[1] = np.where(start[1] < 0.4, 1, 0)
    produced[2] = np.where(start[2] < 0.5, rng.integers(1, 4, q), 0)
    produced[2, :133] = [62] * 131 + [40, 62]  # pb[132] = WIN - 30
    produced[3] = np.where(start[3] < 0.2, rng.integers(1, 63, q), 0)
    pb = np.cumsum(produced, axis=1) - produced
    pb[3] += 100
    assert pb[0, -1] >= 4 * win and pb[1, -1] < win
    assert pb[2, 132] == win - 30 and pb[2, 133] == win + 32
    one = np.where(rng.random((1, q)) < 0.57, rng.integers(1, 8, (1, q)), 0)
    one = np.cumsum(one, axis=1) - one
    return [(_t(p.astype(np.int32), device), _t(_words(rng, p.shape), device),
             n_cap) for p, n_cap in ((pb, 4 * win), (one, 2 * win))]


def _windowed(rng, q, device, call, n_fill=6, place=True):
    """Max |wrapper - plain| over the windowed cases; call(pb, emits, n_cap)
    runs the wrapper."""
    return max(max_abs_err(call(pb, em, n_cap),
                           place_kernel.place_fill_reference(
                               pb, em, n_cap, n_fill, place))
               for pb, em, n_cap in _window_cases(rng, q, device))


def _place_wide(device) -> int:
    """E2 at every lanes on the windowed cases, on reach_case at reach 63
    and on narrow_case at Q = 8,000 and 7,999 (16-byte and scalar row
    loads)."""
    pw = place_window
    rng = np.random.default_rng(19)
    cases = [reach_case(6, rng, device)] + [narrow_case(rng, q, device)
                                            for q in (8000, 7999)]
    err = 0
    for lanes in pw.WIDE_LANES:
        call = lambda pb, em, n, lanes=lanes: pw.place_wide(
            pb, em, pw.window_base_rows_w(pb, n, lanes), n, lanes=lanes)
        err = max([err, _windowed(np.random.default_rng(8), 4000, device,
                                  call)]
                  + [max_abs_err(call(pb, em, n),
                                 place_kernel.place_fill_reference(pb, em, n))
                     for pb, em, n in cases])
    return err


def _place_fill2(device) -> int:
    pw = place_window
    err = _windowed(np.random.default_rng(9), 4224, device,
                    lambda pb, em, n: pw.place_fill2(
                        pb, em, pw.window_base_rows(pb, n), n))
    rng = np.random.default_rng(16)
    return max([err] + [fill2_err(*fill2_case(name, rng, device))
                        for name in FILL2_CASES])


# E3's cases, each B = 3 images of 8 units (16 windows) of two windows
FILL2_CASES = ("chunks of 8 and 9", "second window empty",
               "units with no writer", "tail rows only")
FILL2_WINDOWS = 16
# each case's window kinds per image (_fill2_image); windows 2u and 2u + 1
# make unit u
_FILL2_KINDS = {
    "chunks of 8 and 9": (
        ["short", "nine"] * 4 + ["nine", "short", "long", "short"] * 2,
        ["nine", "short", "short", "long"] * 4,
        ["short"] * 15 + ["nine"]),
    "second window empty": (
        ["short", "empty", "short", "short", "gap end", "empty"] * 2
        + ["long", "empty", "short", "empty"],
        ["long", "empty"] * 8,
        ["gap end", "empty"] * 7 + ["short", "empty"]),
    "units with no writer": (
        ["short", "short", "gap end"] + ["empty"] * 7 + ["short"] * 6,
        ["empty"] * 4 + ["short"] * 2 + ["empty"] * 6 + ["long"] * 4,
        ["gap end"] + ["empty"] * 15),
    "tail rows only": (
        ["short"] * 14 + ["tail"] * 2,
        ["long", "nine"] * 6 + ["short", "tail", "tail", "tail"],
        ["short"] * 13 + ["gap end", "tail", "tail"]),
}


def _fill2_image(rng, kinds, win):
    """Sorted row offsets of one E3 image over len(kinds) windows of win
    pixels.  A window's kind: "short", chunks of 1-8 pixels, one of them
    exactly 8; "nine", chunks of 1-8 and one of exactly 9; "long", chunks
    of 1-62 with one of 62 and one of 40; "gap end", short chunks, then a
    last chunk 100 pixels before the window's end; "empty", no row starts
    in it (the chunk before runs over it into the next window with rows, 5
    pixels in); "tail", no row starts in it or after it (the rows left sit
    at pb = n_cap)."""
    pos, p = [], 0
    for w, kind in enumerate(kinds):
        if kind == "tail":
            break
        if kind == "empty":
            p = (w + 1) * win + 5
            continue
        end = (w + 1) * win - (100 if kind == "gap end" else 0)
        top = 62 if kind == "long" else 8
        lengths = []
        while p + sum(lengths) < end:
            lengths.append(int(rng.integers(1, top + 1)))
        force = {"short": [8], "nine": [9], "long": [62, 40]}.get(kind, [])
        for i, n in enumerate(force):
            if len(lengths) > 2 + i:
                lengths[len(lengths) // 2 + i] = n
        starts = p + np.cumsum([0] + lengths[:-1])
        keep = starts < end  # the forced chunks may push the last ones out
        pos.extend(starts[keep])
        p += sum(np.array(lengths)[keep])
        if kind == "gap end":
            pos.append(end)
            p = end + 100
    return np.array(pos, np.int64)


def fill2_case(name: str, rng, device):
    """(pb, emits, n_cap) of E3 case ``name`` of FILL2_CASES: B = 3 images
    of FILL2_WINDOWS windows, Q a multiple of 128 with at least 128 tail
    rows at pb = n_cap."""
    win = place_kernel.WIN
    n_cap = FILL2_WINDOWS * win
    images = [_fill2_image(rng, kinds, win) for kinds in _FILL2_KINDS[name]]
    q = (max(x.size for x in images) // 128 + 2) * 128
    pb = np.full((len(images), q), n_cap, np.int64)
    for i, x in enumerate(images):
        x = x[x < n_cap]
        pb[i, : x.size] = x
    return (_t(pb.astype(np.int32), device), _t(_words(rng, pb.shape), device),
            n_cap)


def fill2_err(pb, emits, n_cap) -> int:
    """Max |E3 - plain| on the whole output."""
    pw = place_window
    return max_abs_err(
        pw.place_fill2(pb, emits, pw.window_base_rows(pb, n_cap), n_cap),
        place_kernel.place_fill_reference(pb, emits, n_cap))


def _rows_at(rng, pixels, q, n_cap, dup=0.5):
    """(q,) int64 sorted pb whose writers are exactly ``pixels`` (sorted,
    distinct, below n_cap): each pixel gets one row, and with probability
    ``dup`` one to three more rows before it at the same pb (rows that do
    not write); the rows left sit at pb = n_cap."""
    extra = np.where(rng.random(len(pixels)) < dup,
                     rng.integers(1, 4, len(pixels)), 0)
    pb = np.repeat(np.asarray(pixels, np.int64), 1 + extra)
    assert pb.size <= q, (pb.size, q)
    return np.concatenate([pb, np.full(q - pb.size, n_cap, np.int64)])


def reach_case(n_fill: int, rng, device):
    """(pb, emits, n_cap) of E6's reach at n_fill, R = 2**n_fill - 1: B =
    2 images of 4 windows, Q a multiple of 128.  Consecutive writers lie R,
    R + 1 or R + 2 pixels apart (the pixel before a writer is R - 1, R or
    R + 1 from the one before it) or 1-70 apart, from a random offset, so
    the reach ends on every position of a 32-pixel mask word and runs
    across word edges.  Image 0 writes window 0's first pixel, window 1's
    last pixel, and the pixel R before window 2's last with no writer
    after it in the window (its last pixel is just reached); image 1 writes
    the pixel R + 1 before window 0's last with none after it (its last
    pixel takes the carry), no pixel of window 1, and window 2's first."""
    win = place_kernel.WIN
    r = (1 << n_fill) - 1
    n_cap = 4 * win
    images = []
    for forced, clear in (({0, 2 * win - 1, 3 * win - 1 - r},
                           [(3 * win - r, 3 * win)]),
                          ({win - 2 - r, 2 * win},
                           [(win - 1 - r, win), (win, 2 * win)])):
        pos, x = set(), int(rng.integers(0, 40))
        while x < n_cap:
            pos.add(x)
            x += int(rng.choice([r, r + 1, r + 2, int(rng.integers(1, 71))]))
        pos = {x for x in pos if not any(a <= x < b for a, b in clear)}
        images.append(np.array(sorted(pos | forced), np.int64))
    assert {0, 31} <= {int(x + r) % 32 for img in images for x in img}
    q = (max(2 * x.size for x in images) // 128 + 2) * 128
    pb = np.stack([_rows_at(rng, x, q, n_cap) for x in images])
    return (_t(pb.astype(np.int32), device), _t(_words(rng, pb.shape), device),
            n_cap)


# E5's pinned groups: (image, first row, its pb, rows 0-1 pixels each)
# -- image 0: a group inside window 0's last stripe, and the next one
# across the window edge; image 1: a group from 300 pixels before window
# 2, and one inside window 2's last stripe with rows past n_cap after it
NARROW_PINS = ((0, 3840, place_kernel.WIN - 92, True),
               (1, 2048, 2 * place_kernel.WIN - 300, False),
               (1, 5120, 3 * place_kernel.WIN - 100, True))


def narrow_case(rng, q: int, device):
    """(pb, emits, n_cap) of E5's edges: B = 2 images of Q = q rows (q >=
    5,376, any q) over 3 windows.  Rows produce 0, 0, 1, 1 or 2 pixels,
    one in a hundred a run of 5-62, so groups of 128 rows span a few
    stripes, some more; at each of NARROW_PINS the row's pb jumps to the
    pinned pixel and (True) the group's 128 rows produce 0 or 1 pixel, so
    its writers span under 128 pixels: a span that the window's last
    stripes clamp at any ns, and the group after it across the window
    edge."""
    win = place_kernel.WIN
    n_cap = 3 * win
    inc = rng.choice([0, 0, 1, 1, 2], (2, q))
    runs = rng.random((2, q)) < 0.01
    inc[runs] = rng.integers(5, 63, runs.sum())
    for b, row, _, thin in NARROW_PINS:
        if thin:
            inc[b, row : row + 128] = rng.integers(0, 2, 128)
    pb = np.cumsum(inc, axis=1) - inc
    for b, row, pixel, _ in NARROW_PINS:
        assert pb[b, row] <= pixel
        pb[b, row:] += pixel - pb[b, row]
    return (_t(pb.astype(np.int32), device), _t(_words(rng, pb.shape), device),
            n_cap)


def _place_fill_narrow(device) -> int:
    """E5 at ns 1, 2, 4 and 64 on the windowed cases and on narrow_case at
    Q = 8,000 (16-byte row loads) and 7,999 (Q % 4 != 0: scalar loads)."""
    pw = place_window
    rng = np.random.default_rng(17)
    cases = [narrow_case(rng, q, device) for q in (8000, 7999)]
    err = 0
    for ns in (1, 2, 4, pw.SW):
        call = lambda pb, em, n, ns=ns: pw.place_fill_narrow(
            pb, em, pw.window_base_rows(pb, n), n, ns=ns)
        err = max([err, _windowed(np.random.default_rng(10), 4000, device,
                                  call)]
                  + [max_abs_err(call(pb, em, n),
                                 place_kernel.place_fill_reference(pb, em, n))
                     for pb, em, n in cases])
    return err


def _place_variant(device) -> int:
    """E6's 21 instantiations (do_dma, do_slabs, n_fill) on the windowed
    cases and on reach_case at every n_fill."""
    pw = place_window
    rng = np.random.default_rng(18)
    reach = [reach_case(n, rng, device) for n in range(7)]
    err = 0
    for dma, slabs in ((True, True), (True, False), (False, False)):
        for n_fill in range(7):
            call = lambda pb, em, n: pw.place_variant(
                pb, em, pw.window_base_rows(pb, n), n, do_dma=dma,
                do_slabs=slabs, n_fill=n_fill)
            err = max([err, _windowed(np.random.default_rng(11), 4224,
                                      device, call, n_fill, slabs)]
                      + [max_abs_err(call(pb, em, n),
                                     place_kernel.place_fill_reference(
                                         pb, em, n, n_fill, slabs))
                         for pb, em, n in reach])
    return err


# E4's (win, g) in _place_grouped: one window a step, and steps of 2, 8 and
# 16 windows (the largest step, 16,384 pixels, at 1,024 and 2,048 a window)
GROUPED_SHAPES = ((place_kernel.WIN, 1), (1024, 2), (1024, 16), (2048, 8))


def _grouped_image(rng, win, g, n_cap, dense):
    """Sorted pixel positions of one E4 image: ``dense`` increments
    (0 makes equal-pb rows) with a run of win + 300 equal rows (more than
    the TPU kernel's win / 128 + 2 slabs hold) up to a gap of 100 across
    the window edge inside step 1 (a step edge at g = 1), on to a gap of
    100 across the edge of steps 1 and 2, a little further, then an empty
    tail of more than two steps."""
    step = win * g
    out, p = [], 0
    for stop, jump in ((step + win - 24, step + win + 76),
                       (2 * step - 30, 2 * step + 70), (2 * step + 500, None)):
        while p < stop:
            out.append(p)
            p += int(rng.choice(dense))
        if jump is not None:
            out.append(stop)
            p = jump
    assert 5 * step == n_cap
    out[50:50] = [out[50]] * (win + 300)
    return np.array(out, np.int64)


def _grouped_cases(rng, win, g):
    """[(pb, emits, n_cap)] numpy inputs of E4: B = 2 (image 0 has equal-pb
    runs of 2, 3, 256 and 101 rows, the last over rows 2,000-2,100 across
    the kernel's first tile edge, and runs past n_cap; image 1 is
    _grouped_image, whose run of win + 300 rows puts more than 256 rows
    on one pixel) and B = 1 (image 1 alone)."""
    n_cap = 5 * win * g
    one = _grouped_image(rng, win, g, n_cap, [0, 1, 1, 2, 3, 5])
    inc = rng.choice([0, 1, 1, 2, 3, 5, 17, 62], one.size)
    inc[[100, 200, 201]] = 0
    inc[300:555] = 0
    inc[2000:2100] = 0
    zero = np.cumsum(inc) - inc
    assert zero[-1] >= n_cap
    pb = np.stack([zero, one]).astype(np.int32)
    pb[1, -5:] = n_cap + np.arange(5)  # rows at and past n_cap
    return [(pb, _words(rng, pb.shape), n_cap),
            (pb[1:], _words(rng, (1, pb.shape[1])), n_cap)]


def grouped_err(win: int, g: int, device) -> int:
    """Max |E4 - plain| on the whole output at (win, g): lr_mode cnt, dyn
    and smem on _grouped_cases, and every lr_mode with and without
    static_inputs on 1,000 rows over five steps, which the timing-only
    modes' fixed range holds."""
    pw = place_window
    err = 0

    def run(pb, em, n_cap, mode, static_in):
        tpb, tem = _t(pb, device), _t(em, device)
        base = pw.step_base_rows(tpb, n_cap, win if mode == "smem"
                                 else win * g)
        return max_abs_err(
            pw.place_grouped(tpb, tem, base, n_cap, win=win, g=g,
                             lr_mode=mode, static_inputs=static_in),
            pw.summed_place_reference(tpb, tem, n_cap, win, g))

    rng = np.random.default_rng(12 + g)
    for pb, em, n_cap in _grouped_cases(rng, win, g):
        for mode in ("cnt", "dyn", "smem"):
            err = max(err, run(pb, em, n_cap, mode, False))
    inc = rng.choice([0, 1, 2, 5, 17, 62, 200], (2, 1000))
    pb = (np.cumsum(inc, axis=1) - inc).astype(np.int32)
    n_cap = 5 * win * g
    em = _words(rng, pb.shape)
    for mode in pw.LR_MODES:
        for static_in in (False, True):
            err = max(err, run(pb, em, n_cap, mode, static_in))
    return err


def _place_grouped(device) -> int:
    return max(grouped_err(win, g, device) for win, g in GROUPED_SHAPES)


# E7's trailing runs of equal offs: case -> (the run's offset in each
# image, C ragged, out_cap in windows, interior runs (image, rows, beside))
_W7 = emit_kernel.WIN
EMIT_RUN_CASES = {
    "run mid-window": ((2 * _W7 + 4000, _W7 + 1234), False, 4, ()),
    "run at a window's first byte": ((2 * _W7, 3 * _W7), False, 4, ()),
    "run at a window's last bytes": (
        tuple(3 * _W7 - k for k in range(1, 6)), False, 4, ()),
    "run past out_cap": ((3 * _W7, 3 * _W7 + 100), False, 3, ()),
    "ragged C": ((2 * _W7 + 777, 3 * _W7 - 2), True, 4, ()),
    "interior run beside a trailing one": (
        (2 * _W7 + 2500, 3 * _W7 - 3000), False, 4,
        ((0, 3000, True), (1, 2500, False))),
}
EMIT_RUN_ROWS = 3000  # the shortest trailing run of a case


def emit_run_case(name: str, rng, device):
    """(off, tlo, thn, out_cap) of EMIT_RUN_CASES[name]: image i's rows
    emit 1-6 bytes each up to its run's offset, then its last rows (at
    least EMIT_RUN_ROWS of them) share that offset; C is a multiple of 512,
    or (ragged) one more than 57 past it, which C % 4 != 0 reads row by
    row.  An interior run is ``rows`` rows at one offset, either just
    before the trailing run (``beside``: its last row emits the 4 bytes up
    to it) or in the image's first third."""
    targets, ragged, windows, interior = EMIT_RUN_CASES[name]
    before = [int(t * 0.9 / 3.5) for t in targets]  # rows before each run
    c = -(-(max(before) + EMIT_RUN_ROWS) // 512) * 512 + (57 if ragged else 0)
    off = np.empty((len(targets), c), np.int64)
    for i, (t, r) in enumerate(zip(targets, before)):
        nb = rng.integers(1, 7, r)
        for image, rows, beside in interior:
            if image == i:
                at = r - rows if beside else r // 3
                nb[at : at + rows - 1] = 0
                if beside:
                    nb[r - 1] = 4
        first = t - int(nb.sum())
        assert first >= 0, (name, i)
        off[i, :r] = first + np.cumsum(nb) - nb
        off[i, r:] = t
    args = [_t(off.astype(np.int32), device)] + [
        _t(_words(rng, off.shape), device) for _ in range(2)]
    return (*args, windows * _W7)


def _emit_window(device) -> int:
    """E7 at every lanes on rows of 1-8 bytes with an interior run of
    20,000 rows, and on every EMIT_RUN_CASES case."""
    rng = np.random.default_rng(13)
    win = emit_kernel.WIN
    b, c, out_cap = 3, 25000, 16 * win
    nbytes = rng.choice([1, 2, 3, 4, 5, 6, 6, 7, 8], (b, c))
    nbytes[1, 100:20100] = 0  # a run of 20,000 equal offs, then its cover
    off = 14 + np.cumsum(nbytes, axis=1) - nbytes
    off[0, 1500:] += win - 3 - off[0, 1500]  # row 1500 crosses an edge
    off[2] += out_cap - off[2, c // 2]  # rows at and past out_cap
    assert off[0].max() < out_cap and off[2].max() >= out_cap
    args = [_t(x.astype(np.int32), device) for x in (off,)] + [
        _t(_words(rng, (b, c)), device) for _ in range(2)]
    cases = [(*args, out_cap)] + [emit_run_case(name, rng, device)
                                  for name in EMIT_RUN_CASES]
    return max(emit_window_err(*case) for case in cases)


def emit_window_err(off, tlo, thn, out_cap: int) -> int:
    """Max |E7 - plain| over every lanes."""
    want = emit_window.emit_wide_reference(off, tlo, thn, out_cap)
    return max(max_abs_err(emit_window.emit_wide(
        off, tlo, thn, emit_window.window_base_rows_w(off, out_cap, lanes),
        out_cap, lanes=lanes), want)
        for lanes in place_window.WIDE_LANES)


def _grid_step(device) -> int:
    x = _words(np.random.default_rng(14), (37, 8, 128))
    x[0, 0, :7] = 0xFFFFFFFF
    tx = _t(x, device)
    got = probes.grid_step_probe(tx)
    assert not bool(got[0, 0, :7].any())
    return max_abs_err(got, probes.grid_step_reference(tx))


def _onehot_place(device) -> float:
    rng = np.random.default_rng(15)
    nblk, k, s = 40, 2055, probes.S
    t = rng.integers(0, s * 128, (nblk, k))
    t[3, rng.permutation(k)[:64]] = 1000  # a bin hit 64 times
    t[5, :4] = (-1, s * 128, s * 128 + 5, -300)  # outside the bins
    v = rng.random((nblk, k)).astype(np.float32)
    tt, tv = _t(t.astype(np.int32), device), _t(v, device)
    got = probes.onehot_place(tt, tv, s)
    return float((got - probes.onehot_place_reference(tt, tv, s)).abs().max())


# (B, Qb) of the chunk-start scan's byte soup, around its 4,096-byte tile
CHUNK_STARTS_SHAPES = ((1, 128), (3, 512), (2, 37 * 128), (1, 4096),
                       (2, 4096 + 128), (2, 70 * 4096 + 128))
CHUNK_STARTS_FILLS = (0x00, 0x80, 0xFE, 0xFF)  # one tag a row: len 1, 2, 4, 5
# (first column, bytes after the row) of the wider planes whose views the
# scan reads: rows 16-byte aligned, then 8 (the stream window's qb + 8), 4
# and 1
CHUNK_STARTS_VIEWS = ((0, 0), (0, 8), (0, 4), (1, 7))


def chunk_starts_err(regions) -> int:
    """|kernel - plain| of the chunk-start scan on regions."""
    return max_abs_err(boundary.chunk_starts_batch(regions),
                       boundary.chunk_starts_batch_plain(regions))


def strided_view(host: np.ndarray, device, first: int, after: int):
    """host (B, Qb) as the [:, first:first + Qb] view of a (B, first + Qb +
    after) plane on device."""
    b, qb = host.shape
    plane = np.zeros((b, first + qb + after), np.uint8)
    plane[:, first:first + qb] = host
    return _t(plane, device)[:, first:first + qb]


def _chunk_starts(device) -> int:
    # the two-level experiment's byte soup (that package imports this one)
    from ..benchmarks.expt_boundary2l import _rand_streams

    rng = np.random.default_rng(23)
    err = 0
    for b, qb in CHUNK_STARTS_SHAPES:
        err = max(err, chunk_starts_err(_t(_rand_streams(rng, b, qb),
                                           device)))
    for tag in CHUNK_STARTS_FILLS:
        err = max(err, chunk_starts_err(_t(np.full((2, 9 * 4096 + 256), tag,
                                                   np.uint8), device)))
    mixed = np.full((2, 40 * 4096), 0xFF, np.uint8)
    mixed[:, ::7] = 0x00
    err = max(err, chunk_starts_err(_t(mixed, device)))
    soup = _rand_streams(rng, 5, 3 * 4096 + 128)
    for first, after in CHUNK_STARTS_VIEWS:
        err = max(err, chunk_starts_err(strided_view(soup, device, first,
                                                     after)))
    return err


GATHER_CASES = ("alignments", "tile edges", "source tail", "many segments")
GATHER_SENTINEL = 0xA5


def gather_case(name: str, rng, device):
    """(src words, segment table, output bytes) of a G1 edge case; no two
    segments' outputs touch."""
    tile = gather_kernel.TILE_PX
    n_words = 1 << 16
    if name == "alignments":  # source 0-3 x output 0-15 x RGB, RGBA
        lens = [(1, 2, 3, 4, 5, 37)[k % 6] for k in range(128)]
    elif name == "tile edges":
        lens = [tile - 1, tile, tile + 1, tile - 3, 3 * tile + 5, 1]
    elif name == "source tail":
        n_words = 3 * tile + 7
        lens = [5, tile + 2, n_words]
    else:
        n_words = 300 * 700
        lens = rng.integers(1, 700, 300).tolist()
    segs, dst = [], 0
    for k, n in enumerate(lens):
        if name == "source tail":
            s = n_words - n
        else:
            s = int(rng.integers(0, n_words - n - 3))
        c = 3 + k % 2
        dst += 1 + int(rng.integers(0, 4))
        if name == "alignments":
            s += k % 4 - s % 4
            c = 3 + k // 64
            dst += ((k // 4) % 16 - dst) % 16
        segs.append((s, n, dst, c))
        dst += n * c
    return (_t(_words(rng, n_words), device),
            gather_kernel.segment_table(segs), dst + 7)


def gather_err(src, table, out_bytes: int) -> int:
    """|kernel - plain| of G1 over its whole output, both written into a
    sentinel."""
    got, want = (torch.full((out_bytes,), GATHER_SENTINEL, dtype=torch.uint8,
                            device=src.device) for _ in range(2))
    gather_kernel.gather_pixels(src, table, got)
    gather_kernel.gather_pixels_plain(src, table, want)
    return max_abs_err(got, want)


def _gather_pixels(device) -> int:
    rng = np.random.default_rng(25)
    return max(gather_err(*gather_case(name, rng, device))
               for name in GATHER_CASES)


CASES = {"replay": _replay, "place_fill": _place_fill, "compact": _compact,
         "emit": _emit, "replay_summary": _replay_summary,
         "logfill": _logfill, "fields": _fields, "place_wide": _place_wide,
         "place_fill2": _place_fill2, "place_fill_narrow": _place_fill_narrow,
         "place_variant": _place_variant, "place_grouped": _place_grouped,
         "emit_window": _emit_window, "grid_step": _grid_step,
         "onehot_place": _onehot_place, "chunk_starts": _chunk_starts,
         "gather_pixels": _gather_pixels}


def check(name: str, device):
    """Max |kernel - plain| of kernel ``name`` over its edge cases (an int
    but for onehot_place's float32 bins)."""
    return CASES[name](torch.device(device))
