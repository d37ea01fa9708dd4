"""Parallel QOI encoder.

After the encoder processes a differing pixel p, table slot hash(p) holds
p whatever op was emitted, and run pixels never touch the table; so the
table, and with it every op decision, is a pure function of the pixel
sequence.  Every device encoder ends in one emit stage: its compacted
6-byte templates (thn bits 16+ the byte count) get their closing rows
and a 1-byte sentinel row and their byte offsets (``stream_offsets``,
under ``encode.templates``), then K4 writes them and the stream is
zeroed past its length (``emit_stream``, under ``encode.emit``).

``encode_rows`` runs fields-first over rows of pixel words, each from the
state carried into it (the batch encoder's whole images, the streaming
windows, a sequence-parallel shard):

1. E1 (``ops/fields_kernel``) writes every pixel's template (run streak,
   RUN-62 flush, same-hash lookup, op selection) and the trailing runs;
   the pixels that emit bytes are the chunk rows (``encode.fields``);
2. K3 compacts the templates to those rows (``encode.compact``);
3. the emit stage.

The packed-lane encoder (``_encode_lanes_impl``) still runs
compact-first: its dense pass (``lane_positions``), K3 on the pixels and
the template passes on the chunk rows (``lane_templates``), then the
emit stage.  The batch encoder's compact-first reference lives in
``kernels/selfcheck``.
"""

from __future__ import annotations

import torch

from ..utils import tracing
from .bitops import START_PIXEL_PACKED, hash6, to_int8, unpack_channel
from .compact_kernel import BLK as CBLK
from .compact_kernel import compact_rows
from .emit_kernel import WIN as EMIT_WIN
from .emit_kernel import emit_bytes

TILE = 64  # nb granularity, kept so encode shapes match the JAX package

TAG_RGB = 0xFE
TAG_RGBA = 0xFF
TAG_INDEX = 0x00
TAG_DIFF = 0x40
TAG_LUMA = 0x80
TAG_RUN = 0xC0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_to_tile(n: int) -> int:
    return _round_up(n, TILE)


def bucket_size(n: int) -> int:
    """The JAX package's pixel-count bucket: a power of two of TILEs, or a
    step of 1/8 of it below, whichever first holds n (the one-shot
    encoder's padded width)."""
    n = max(n, TILE)
    b = TILE
    while b < n:
        b *= 2
    for frac in (b // 2 + b // 8, b // 2 + b // 4, b // 2 + 3 * b // 8,
                 3 * b // 4, 7 * b // 8):
        if frac >= n and frac % TILE == 0:
            return frac
    return b


def _last_same_hash_value(packed, h, noneq, incoming=None):
    """For each position i of each row: the word of the most recent j < i
    with noneq[j] and h[j] == h[i]; where there is none, incoming[h[i]],
    the table carried into the row (a streaming window's), by default the
    encoder's zero-initialised table.

    packed/h/noneq: (B, N) or (N,); incoming: (64,) for every row, or
    (B, 64).  A stable sort of each row by hash puts every hash's positions
    in order, so a position's predecessor is the last noneq entry before it
    inside its hash group."""
    if packed.dim() == 1:
        inc = None if incoming is None else incoming.reshape(1, 64)
        return _last_same_hash_value(packed[None], h[None], noneq[None],
                                     inc)[0]
    n = packed.shape[1]
    order = torch.sort(h.to(torch.int64), dim=1, stable=True).indices
    sh = torch.gather(h, 1, order)
    sne = torch.gather(noneq, 1, order)
    j = torch.arange(n, device=packed.device).expand_as(order)
    # last noneq sorted index strictly before j, and the start of j's group
    cand = torch.where(sne, j, -1)
    last = torch.cummax(torch.cat([torch.full_like(cand[:, :1], -1),
                                   cand[:, :-1]], dim=1), dim=1).values
    new_group = torch.cat([torch.ones_like(sne[:, :1]),
                           sh[:, 1:] != sh[:, :-1]], dim=1)
    group_start = torch.cummax(torch.where(new_group, j, 0), dim=1).values
    found = last >= group_start
    pred = torch.gather(torch.gather(packed, 1, order), 1, last.clamp(min=0))
    if incoming is None:
        fallback = 0
    else:
        inc = incoming.reshape(-1, 64).expand(packed.shape[0], 64)
        fallback = torch.gather(inc, 1, sh.to(torch.int64))
    return torch.empty_like(packed).scatter_(1, order,
                                             torch.where(found, pred, fallback))


def op_bytes(px, prev, nq, table_val, h, channels: int):
    """Op selection of the differing pixels nq (precedence INDEX > RGBA >
    DIFF > LUMA > RGB) -> (own_len, (o0, ..., o4)): each pixel's op bytes
    and their count, int32; every other pixel gets 0s."""
    is_index = nq & (table_val == px)
    a_cur = unpack_channel(px, 3)
    if channels == 4:
        is_rgba = nq & ~is_index & (a_cur != unpack_channel(prev, 3))
    else:
        is_rgba = torch.zeros_like(nq)

    dr = to_int8(unpack_channel(px, 0) - unpack_channel(prev, 0))
    dg = to_int8(unpack_channel(px, 1) - unpack_channel(prev, 1))
    db = to_int8(unpack_channel(px, 2) - unpack_channel(prev, 2))
    dr_dg = to_int8(dr - dg)
    db_dg = to_int8(db - dg)
    in_diff = ((dr >= -2) & (dr <= 1) & (dg >= -2) & (dg <= 1)
               & (db >= -2) & (db <= 1))
    in_luma = ((dg >= -32) & (dg <= 31) & (dr_dg >= -8) & (dr_dg <= 7)
               & (db_dg >= -8) & (db_dg <= 7))
    rest = nq & ~is_index & ~is_rgba
    is_diff = rest & in_diff
    is_luma = rest & ~in_diff & in_luma
    is_rgb = rest & ~in_diff & ~in_luma
    own_len = torch.where(
        is_index, 1, torch.where(
            is_rgba, 5, torch.where(
                is_diff, 1, torch.where(is_luma, 2,
                                        torch.where(is_rgb, 4, 0))))
    ).to(torch.int32)

    r8, g8, b8 = (unpack_channel(px, c) for c in range(3))
    diff_byte = TAG_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
    luma0 = TAG_LUMA | (dg + 32)
    luma1 = ((dr_dg + 8) << 4) | (db_dg + 8)
    o0 = torch.where(
        is_index, h, torch.where(
            is_rgba, TAG_RGBA, torch.where(
                is_diff, diff_byte, torch.where(
                    is_luma, luma0, torch.where(is_rgb, TAG_RGB, 0))))
    ).to(torch.int32)
    rgbx = is_rgba | is_rgb
    o1 = torch.where(rgbx, r8, torch.where(is_luma, luma1, 0))
    o2 = torch.where(rgbx, g8, 0)
    o3 = torch.where(rgbx, b8, 0)
    o4 = torch.where(is_rgba, a_cur, 0)
    return own_len, (o0, o1, o2, o3, o4)


def pack_templates(own_len, own, has_run, run_byte):
    """The 6-byte templates as two int32 planes: tlo = bytes 0-3, thn =
    bytes 4-5 | byte count << 16.  Where has_run, run_byte comes first and
    the op bytes follow it."""
    o0, o1, o2, o3, o4 = own
    bytes6 = [torch.where(has_run, hi, lo) for hi, lo in
              zip((run_byte, o0, o1, o2, o3, o4), (o0, o1, o2, o3, o4, 0))]
    nbytes = own_len + has_run.to(torch.int32)
    tlo = bytes6[0] | (bytes6[1] << 8) | (bytes6[2] << 16) | (bytes6[3] << 24)
    thn = bytes6[4] | (bytes6[5] << 8) | (nbytes << 16)
    return tlo, thn


def stream_offsets(tlo_c, thn_c, counts, start: int, trailing=None):
    """The emit stage's first half, which every device encoder runs under
    ``encode.templates`` after its template passes.  Compacted templates
    (B, C) int32 (thn bits 16+ the byte count, rows at or past counts
    arbitrary) and their counts (B,) -> (off, incl, total_len): written
    into tlo_c and thn_c at counts, clamped into the rows as the JAX
    package's dynamic_update_slice clamps them, whole images' two closing
    rows (each stream's ``trailing`` run (B,) and the end marker) and a
    1-byte sentinel row, which keeps the last real row a covered row in
    K4; each row's exclusive and inclusive byte offsets from ``start``
    (rows past the sentinel emit nothing); each stream's length, the
    sentinel excluded."""
    cap = tlo_c.shape[1]
    dev = tlo_c.device
    if trailing is None:
        last = counts.clamp(max=cap - 1)[:, None]
        cols = last.to(torch.int64)
        tlo_c.scatter_(1, cols, 0)
        thn_c.scatter_(1, cols, 1 << 16)
    else:
        # with a trail: [run, 0 x7, 1]; without: [0 x7, 1, 0]; then the
        # sentinel
        ht = (trailing > 0).to(torch.int32)
        rows3 = (counts.clamp(max=cap - 3)[:, None] + torch.arange(
            3, dtype=torch.int32, device=dev)[None, :])
        cols = rows3.to(torch.int64)
        tlo_c.scatter_(1, cols, torch.stack(
            [ht * (TAG_RUN | ((trailing - 1) & 0x3F)), 256 << (8 * ht),
             torch.zeros_like(ht)], 1))
        thn_c.scatter_(1, cols, torch.stack(
            [torch.full_like(ht, 6 << 16), (2 + ht) << 16,
             torch.full_like(ht, 1 << 16)], 1))
        last = rows3[:, 2:]
    # int32 on both sides: a mixed compare over every row runs in int64
    rows = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    off, incl = row_offsets(torch.where(rows <= last, thn_c >> 16, 0), start)
    return off, incl, incl[:, -1] - 1


def row_offsets(nb_c, start: int):
    """Exclusive running sums along the rows of nb_c (B, R) int32, which
    it overwrites, each row's from start -> (off, incl) (B, R) int32, the
    exclusive and inclusive sums.  One scan over the rows laid end to
    end: torch scans a 1-D tensor in one device-wide pass, on an H100
    about 12x faster than its scan along the rows of 32 x 2 M; each row's
    first count takes off what the rows before it sum to and adds start,
    so the running sum restarts at start in each row (and stays within
    one row's sum)."""
    b, r = nb_c.shape
    tot = nb_c.sum(dim=1, dtype=torch.int32)
    nb_c[:, 0] += torch.cat([tot.new_full((1,), start), -tot[:-1]])
    incl = torch.cumsum(nb_c.view(-1), dim=0, dtype=torch.int32).view(b, r)
    off = incl - nb_c
    off[:, 0] = start
    return off, incl


def nth_chunk(keep, n: int):
    """Each row's position of its n-th chunk row: keep (B, Nb) bool, n >=
    1 -> (B,) int32 (Nb - 1 in a row of fewer)."""
    before, _ = row_offsets(keep.to(torch.int32), 0)
    return (before < n).sum(dim=1, dtype=torch.int32) - 1


@tracing.traced("encode.emit")
def emit_stream(off, tlo_c, thn_c, total_len, out_cap: int):
    """The emit stage's second half: K4 writes the rows of stream_offsets'
    templates at off -> (B, out_cap) uint8, zeroed past each stream's
    total_len."""
    out = emit_bytes(off, tlo_c, thn_c, out_cap)
    col = torch.arange(out_cap, dtype=torch.int32, device=out.device)[None, :]
    return torch.where(col < total_len[:, None], out, 0)


def caps_ok(counts, chunk_cap: int, total_len, out_cap: int):
    """(B,) bool: each row's chunk rows within K3's margin of chunk_cap
    and its stream within out_cap.  A row flagged not ok overflowed a cap
    and must be encoded again with larger ones."""
    return (counts + CBLK + 128 <= chunk_cap) & (total_len <= out_cap)


def encode_rows(packed, n_px, channels: int, chunk_cap: int | None = None,
                out_cap: int | None = None, carry=(), header=None,
                close: bool = False):
    """E1 -> K3 -> the emit stage over B rows of pixel words, each from the
    state carried into it: the batch encoder's whole images, a streaming
    window's rows and a sequence-parallel shard.

    packed: (B, Nb) int32, Nb a multiple of 64; n_px: the valid pixels of
    each row, (B,) int32, or an int for every row; carry: (prev_in (B,),
    run_in (B,), seen_in (64, B)) int32, by default the start of an
    image; header: None, or a (14,) uint8 header each stream starts with;
    close: each stream ends with its trailing run and the end marker (n_px
    an int).  chunk_cap and out_cap default to caps that no row overflows
    (Nb + 3 chunk rows, 1 + channels bytes a pixel).

    Returns (out (B, out_cap) uint8 streams zeroed past each length,
    lengths (B,) int32, counts (B,) int32 chunk rows, and E1's run_out
    (B, ceil(Nb / 2048)) and seen_out (64, B)).  Whole images come out
    byte for byte as the compact-first stages make them, also where a cap
    overflows (caps_ok)."""
    from .fields_kernel import BLK, encode_fields_planes

    b, nb = packed.shape
    if chunk_cap is None:
        chunk_cap = _round_up(nb + 3, 128)
    if out_cap is None:
        out_cap = _round_up((channels + 1) * nb + 64, EMIT_WIN)
    v = n_px if torch.is_tensor(n_px) else torch.full(
        (b,), n_px, dtype=torch.int32, device=packed.device)
    with tracing.span("encode.fields"):
        tracing.count("fields_rows", b * nb)
        tlo, thn, run_out, seen_out = encode_fields_planes(
            packed.contiguous(), v, channels, *carry)
        keep = thn >= 1 << 16  # differing pixels and RUN-62 flushes
    (tlo_c, thn_c), counts = compact_rows((tlo, thn), keep, cap=chunk_cap)
    with tracing.span("encode.templates"):
        tracing.count("template_rows", b * chunk_cap)
        trailing = None
        if close:
            trailing = run_out[:, (n_px - 1) // BLK]
            if chunk_cap < n_px:
                # a row of more chunks than chunk_cap keeps its first
                # chunk_cap: its trailing run counts from the last one
                # kept, as compact-first counts it
                trailing = torch.where(
                    counts > chunk_cap,
                    n_px - 1 - nth_chunk(keep, chunk_cap), trailing)
        off, incl, lens = stream_offsets(
            tlo_c, thn_c, counts, 0 if header is None else 14, trailing)
        del incl  # the lane encoder's stream ends: freed before K4's output
    out = emit_stream(off, tlo_c, thn_c, lens, out_cap)
    if header is not None:
        out[:, :14] = header
    return out, lens, counts, run_out, seen_out


def encode_caps(nb: int, channels: int, chunk_cap: int | None = None,
                out_cap: int | None = None):
    """The JAX package's (chunk_cap, out_cap) rounding: chunk_cap defaults
    to a bound safe for any input, out_cap to the worst stream size."""
    if chunk_cap is None:
        chunk_cap = nb + CBLK + 256
    chunk_cap = _round_up(max(chunk_cap, CBLK + 256), 128)
    if out_cap is None:
        out_cap = (channels + 1) * nb + 14 + 8 + 9
    return chunk_cap, _round_up(out_cap, EMIT_WIN)


def encode_batch_checked(packed, n_px: int, header, channels: int, *,
                         chunk_cap: int | None = None,
                         out_cap: int | None = None):
    """Batched encode -> ((B, out_cap) uint8, (B,) int32 lengths, (B,) bool
    ok).  With the default caps ok is always True; an image flagged not ok
    overflowed a tighter cap and must be encoded again with a larger one."""
    chunk_cap, out_cap = encode_caps(packed.shape[1], channels, chunk_cap,
                                     out_cap)
    out, lens, counts, _, _ = encode_rows(packed, n_px, channels, chunk_cap,
                                          out_cap, header=header, close=True)
    return out, lens, caps_ok(counts, chunk_cap, lens, out_cap)


def encode_batch(packed, n_px: int, header, channels: int):
    """Batched encode: (B, Nb) int32 pixel words -> ((B, out_cap) uint8
    streams, (B,) int32 lengths); encode_batch_checked at its default
    caps, which never clear an ok flag (a caller with tighter caps calls
    encode_batch_checked and reads the flags)."""
    out, total_len, _ = encode_batch_checked(packed, n_px, header, channels)
    return out, total_len


def encode_core(packed, n_px: int, header, channels: int):
    """One image's (Nb,) pixel words -> ((out_cap,) uint8 stream, 0-d
    length): encode_batch at B = 1."""
    out, total_len = encode_batch(packed[None], n_px, header, channels)
    return out[0], total_len[0]


# ---------------------------------------------------------------------------
# Scatter emission: the differential oracles of the kernel path, in plain
# torch (the JAX package's encode_core_scatter / encode_batch_scatter).
# Each pixel's template byte k lands at its exclusive byte offset + k; for
# a fixed k those offsets only grow and every output byte has one writer,
# so six index_adds and the 9-byte tail place the whole stream.
# ---------------------------------------------------------------------------


def encode_batch_scatter(packed, n_px: int, header, channels: int):
    """(B, Nb) int32 pixel words, n_px valid a row (1 <= n_px <= Nb) ->
    ((B, w_cap) uint8 streams zeroed past each length, (B,) int32
    lengths), w_cap = (channels + 1) * Nb + 31 as the JAX package sizes
    it.  The per-pixel fields are E1's plain version from the start
    state."""
    from .fields_kernel import (BLK, encode_fields_planes_reference,
                                start_state)

    b, nb = packed.shape
    dev = packed.device
    n_px = int(n_px)
    tlo, thn, run_out, _ = encode_fields_planes_reference(
        packed, torch.full((b,), n_px, dtype=torch.int32, device=dev),
        channels, *start_state(b, dev))
    nbytes = ((thn >> 16) & 0xFFFF).to(torch.int64)
    offsets = 14 + torch.cumsum(nbytes, dim=1) - nbytes
    chunks_end = 14 + nbytes.sum(dim=1)

    w_cap = (channels + 1) * nb + 14 + 8 + 9
    row = w_cap + 1  # the last column takes the clamped indices
    base = torch.arange(b, dtype=torch.int64, device=dev)[:, None] * row
    out = torch.zeros(b * row, dtype=torch.int32, device=dev)
    for k in range(6):
        plane = tlo if k < 4 else thn
        byte = (plane >> (8 * (k % 4))) & 0xFF
        contrib = torch.where(k < nbytes, byte, 0)
        out.index_add_(0, (base + (offsets + k).clamp(max=w_cap)).reshape(-1),
                       contrib.reshape(-1))

    # the trailing run (the run counter after pixel n_px - 1) and the end
    # marker: [run, 0 x 7, 1] with a run, else [0 x 7, 1, 0]
    trailing = run_out[:, (n_px - 1) // BLK]
    has_trail = trailing > 0
    marker = torch.tensor([0, 0, 0, 0, 0, 0, 0, 1, 0], dtype=torch.int32,
                          device=dev)
    tail = torch.where(
        has_trail[:, None],
        torch.cat([(TAG_RUN | ((trailing - 1) & 0x3F))[:, None],
                   marker[None, :8].expand(b, 8)], dim=1),
        marker[None, :])
    tail_at = (chunks_end[:, None] + torch.arange(9, device=dev)[None, :])
    out.index_add_(0, (base + tail_at.clamp(max=w_cap)).reshape(-1),
                   tail.reshape(-1))

    out = (out & 0xFF).to(torch.uint8).reshape(b, row)[:, :w_cap]
    out[:, :14] = header.to(torch.uint8)
    total_len = chunks_end + has_trail.to(torch.int64) + 8
    col = torch.arange(w_cap, device=dev)[None, :]
    out = torch.where(col < total_len[:, None], out, 0)
    return out, total_len.to(torch.int32)


def encode_core_scatter(packed, n_px: int, header, channels: int):
    """One image's (Nb,) pixel words -> ((w_cap,) uint8 stream, 0-d int32
    length): encode_batch_scatter at B = 1."""
    out, total_len = encode_batch_scatter(packed[None], n_px, header,
                                          channels)
    return out[0], total_len[0]


# ---------------------------------------------------------------------------
# Packed-lane encode: many whole streams per compaction and emission lane
# (models/packed.PackedEncoder), the port of the JAX package's
# _encode_lanes_impl.  Streams of any geometry and channels lie back to
# back in a lane's pixel domain, each followed by two tail slots whose
# compacted rows carry its trailing run and end marker; a flag plane built
# at pack time marks stream starts, tail slots and real pixels.
# ---------------------------------------------------------------------------

FLAG_SEG_START = 1  # first pixel of a stream
FLAG_TAIL0 = 2      # tail slot: trailing-run byte + end-marker bytes 0..4
FLAG_TAIL1 = 4      # tail slot: end-marker bytes 5..7
FLAG_VALID = 8      # a real pixel


def _last_same_hash_value_seg(packed, h, noneq, seg):
    """_last_same_hash_value for packed lanes: entry j is visible to
    position i iff j < i, noneq[j], h[j] == h[i] and seg[j] == seg[i]; a
    position with none reads the fresh table's 0 (a real value: pixel
    (0, 0, 0, 0) hits a fresh table).  seg is nondecreasing along each row,
    so grouping by seg * 64 + hash keeps every predecessor inside its own
    stream.  packed/h/noneq/seg: (B, N) or (N,)."""
    return _last_same_hash_value(packed, seg.to(torch.int64) * 64 + h, noneq)


def _shift_right(x, k: int, fill=0):
    """x (B, N) moved k columns right along each row, fill in front."""
    return torch.cat([torch.full_like(x[:, :k], fill), x[:, :-k]], dim=1)


@tracing.traced("encode.positions")
def lane_positions(packed, flags):
    """Stage 1 of the lane encoder: packed (L, Np) int32, flags (L, Np)
    uint8 -> (packed_aug, posflag, keep, bits): the rows K3 keeps
    (differing pixels, RUN-62 flush points, the tail slots), each pixel
    word with the tail slots' trailing-run byte and has_trail bit in its
    place, each position with the tail0, tail1 and differing flags at the
    bit positions bits = (b_t0, b_t1, b_nq)."""
    l, np_ = packed.shape
    idx = torch.arange(np_, dtype=torch.int32, device=packed.device).expand(
        l, np_)
    f = flags.to(torch.int32)
    seg_start = (f & FLAG_SEG_START) != 0
    t0_d = (f & FLAG_TAIL0) != 0
    t1_d = (f & FLAG_TAIL1) != 0
    valid = (f & FLAG_VALID) != 0

    # dense pass, reset at every stream start
    prev = torch.where(seg_start, START_PIXEL_PACKED,
                       _shift_right(packed, 1, START_PIXEL_PACKED))
    eq_raw = (packed == prev) & valid
    noneq = valid & ~eq_raw
    seg_base = torch.cummax(torch.where(seg_start, idx, 0), dim=1).values
    last_brk = torch.maximum(
        torch.cummax(torch.where(noneq, idx, -1), dim=1).values, seg_base - 1)
    cnt = idx - last_brk
    hit62 = eq_raw & (cnt % 62 == 0)

    # the run pending at a stream's end, read at its tail0 slot (1 past its
    # last pixel) and tail1 slot (2 past): both rows need has_trail
    trail_expr = torch.where(eq_raw, cnt % 62, 0)
    trailing = torch.where(t0_d, _shift_right(trail_expr, 1),
                           torch.where(t1_d, _shift_right(trail_expr, 2), 0))
    has_trail = (trailing > 0).to(torch.int32)
    trail_byte = TAG_RUN | ((trailing - 1) & 0x3F)
    packed_aug = torch.where(
        t0_d, trail_byte | (has_trail << 8),
        torch.where(t1_d, has_trail << 8, packed))
    bits = (21, 22, 23) if np_ <= 1 << 21 else (26, 27, 30)
    b_t0, b_t1, b_nq = bits
    posflag = (idx | (t0_d.to(torch.int32) << b_t0)
               | (t1_d.to(torch.int32) << b_t1)
               | (noneq.to(torch.int32) << b_nq))
    keep = noneq | hit62 | t0_d | t1_d
    return packed_aug, posflag, keep, bits


def lane_table(pk_c, pf_c, counts, bits):
    """Stage 3's table scan of the lane encoder: each compacted row's
    same-hash predecessor word inside its stream
    (_last_same_hash_value_seg, streams cut at the tail1 rows)."""
    _, b_t1, b_nq = bits
    rows = torch.arange(pk_c.shape[1], dtype=torch.int32,
                        device=pk_c.device)[None, :]
    valid_c = rows < counts[:, None]
    pk_c = torch.where(valid_c, pk_c, 0)
    pf_c = torch.where(valid_c, pf_c, 0)
    nq_c = valid_c & (((pf_c >> b_nq) & 1) == 1)
    return _last_same_hash_value_seg(pk_c, hash6(pk_c), nq_c,
                                     _stream_ids(((pf_c >> b_t1) & 1) == 1))


def _stream_ids(t1):
    """Each compacted row's stream in its lane: the tail1 rows (t1 (L, C)
    bool) strictly before it, (L, C) int32."""
    t1_i = t1.to(torch.int32)
    return torch.cumsum(t1_i, dim=1, dtype=torch.int32) - t1_i


@tracing.traced("encode.templates")
def lane_templates(pk_c, pf_c, counts, bits, table_val=None):
    """Stage 3 of the lane encoder: the compacted rows (L, chunk_cap) int32
    and their counts -> (off, tlo, thn, incl, t1, total_len): each row's
    6-byte template (thn bits 16+ the byte count) and stream_offsets'
    sentinel, offsets and lengths; incl, a row's inclusive byte end, is a
    stream's exclusive end at its tail1 rows (t1).
    The segmented same-hash scan runs here unless table_val, lane_table's
    result, is given (a stage profile times the scan on its own).  Counts
    L x chunk_cap ``template_rows``."""
    l, chunk_cap = pk_c.shape
    tracing.count("template_rows", l * chunk_cap)
    b_t0, b_t1, b_nq = bits
    rows = torch.arange(chunk_cap, dtype=torch.int32, device=pk_c.device)[
        None, :]
    valid_c = rows < counts[:, None]
    pk_c = torch.where(valid_c, pk_c, 0)
    pf_c = torch.where(valid_c, pf_c, 0)
    pos = pf_c & ((1 << b_t0) - 1)
    t0 = valid_c & (((pf_c >> b_t0) & 1) == 1)
    t1 = valid_c & (((pf_c >> b_t1) & 1) == 1)
    nq_c = valid_c & (((pf_c >> b_nq) & 1) == 1)
    is_tail = t0 | t1
    run_row = valid_c & ~nq_c & ~is_tail  # RUN-62 flush rows

    # prev pixel: the previous chunk row's, the start pixel on a stream's
    # first row (row 0, or the row after a tail1)
    after_t1 = _shift_right(t1, 1, True)
    prev_c = torch.where(after_t1, START_PIXEL_PACKED,
                         _shift_right(pk_c, 1, START_PIXEL_PACKED))
    gap = torch.where(valid_c, pos - _shift_right(pos, 1, -1) - 1, 0)

    # op selection on the chunk rows, the table reset at every stream; an
    # RGB stream packs alpha 255 everywhere, so the RGBA test never fires
    # for it and needs no channel count
    h = hash6(pk_c)
    if table_val is None:
        table_val = _last_same_hash_value_seg(pk_c, h, nq_c, _stream_ids(t1))
    own_len, own = op_bytes(pk_c, prev_c, nq_c, table_val, h, 4)
    run_byte = torch.where(nq_c, TAG_RUN | ((gap - 1) & 0x3F), TAG_RUN | 61)
    has_run = torch.where(nq_c, gap > 0, run_row)
    tlo, thn = pack_templates(own_len, own, has_run, run_byte)

    # tail rows: the trailing-run byte and the 8-byte end marker split 6 +
    # (2 | 3): tail0 [run or 0, 0 x 5], tail1 [0, 1] or [0, 0, 1]
    ht = (pk_c >> 8) & 1
    tlo = torch.where(t0, ht * (pk_c & 0xFF),
                      torch.where(t1, ((1 - ht) << 8) | (ht << 16), tlo))
    thn = torch.where(t0, 6 << 16, torch.where(t1, (2 + ht) << 16, thn))
    off, incl, total_len = stream_offsets(tlo, thn, counts, 0)
    return off, tlo, thn, incl, t1, total_len


def _encode_lanes_impl(packed, flags, chunk_cap: int, out_cap: int,
                       ends_cap: int):
    """Segmented compact-first encode over packed pixel lanes.

    packed: (L, Np) int32 pixel words (tail slots and padding arbitrary);
    flags:  (L, Np) uint8 FLAG_* bits.
    Returns (out (L, out_cap) uint8 bodies, ends (L, ends_cap) int32 each
    stream's exclusive byte end in pack order (0 past nseg), nseg (L,)
    int32, ok (L,) bool).  Stream s of a lane is out[ends[s-1]:ends[s]];
    headers are not emitted (the caller knows them)."""
    dev = packed.device
    packed_aug, posflag, keep, bits = lane_positions(packed, flags)
    # K3: to the chunk domain
    (pk_c, pf_c), counts = compact_rows((packed_aug, posflag), keep,
                                        cap=chunk_cap)
    off, tlo, thn, incl, t1, total_len = lane_templates(pk_c, pf_c, counts,
                                                        bits)
    # each stream's exclusive byte end sits at its tail1 row: a second,
    # one-plane K3 call over the chunk rows
    (ends,), nseg = compact_rows((incl,), t1, cap=ends_cap)
    cols = torch.arange(ends_cap, dtype=torch.int32, device=dev)[None, :]
    ends = torch.where(cols < nseg[:, None], ends, 0)
    out = emit_stream(off, tlo, thn, total_len, out_cap)
    return out, ends, nseg, caps_ok(counts, chunk_cap, total_len, out_cap)


def encode_lanes_checked(packed, flags, *, chunk_cap: int | None = None,
                         out_cap: int | None = None,
                         ends_cap: int | None = None):
    """Packed-lane encode -> (bodies (L, out_cap) uint8, ends (L,
    ends_cap) int32, nseg (L,) int32, ok (L,) bool); see
    _encode_lanes_impl.  A lane flagged not ok overflowed a cap and must
    be encoded again with larger ones.  The caps round as the JAX
    package's: chunk_cap defaults to a bound safe for any input, out_cap
    to 5 bytes a slot."""
    return _encode_lanes_impl(packed, flags, *lane_caps(
        packed.shape[1], chunk_cap, out_cap, ends_cap))


def lane_caps(np_: int, chunk_cap: int | None = None,
              out_cap: int | None = None, ends_cap: int | None = None):
    """encode_lanes_checked's (chunk_cap, out_cap, ends_cap) for lanes of
    np_ slots, defaulted and rounded as the JAX package's."""
    if chunk_cap is None:
        chunk_cap = np_ + CBLK + 256
    if out_cap is None:
        out_cap = 5 * np_ + 32
    if ends_cap is None:
        ends_cap = CBLK + 256
    return (_round_up(max(chunk_cap, CBLK + 256), 2048),
            _round_up(out_cap, EMIT_WIN),
            _round_up(max(ends_cap, CBLK + 256), 128))
