"""E1: the encoder's per-pixel field pass (CUDA kernel csrc/fields.cu).

For every pixel slot of a row, with the encoder state carried into the row
(prev pixel, run counter 0..61, 64-slot table): the run streak with its
RUN-62 flush, the same-hash table lookup, op selection and the 6-byte
template, packed as two int32 planes, tlo = template bytes 0-3 and thn =
bytes 4-5 | byte count << 16 (the planes K3 compacts and K4 emits).  The
template of a pixel that ends a pending run (or reaches 62) starts with
the RUN byte.  Slots at or past a row's n_px give 0 and 0 and touch no
state, so a row's state out is the state after its last valid pixel.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitops import START_PIXEL_PACKED, hash6
from .encode import (TAG_RUN, TILE, _last_same_hash_value, op_bytes,
                     pack_templates)

BLK = 2048  # pixels per run_out entry (E1's grid block)
SEG_TILE = 1024  # csrc/fields.cu kThreads: pixels per tile, one per thread
SUM_COLS = 65  # csrc/fields.cu kSumCols: summary words per segment
BLOCKS_PER_SM = 2  # the grid E1 aims at: two blocks of 1024 threads an SM


def start_state(b: int, device=None):
    """The encoder's state at the start of an image, for B rows: prev (B,)
    the start pixel, run (B,) 0, seen (64, B) zeros (the encoder's table
    starts empty, unlike the decoder's)."""
    return (torch.full((b,), START_PIXEL_PACKED, dtype=torch.int32,
                       device=device),
            torch.zeros(b, dtype=torch.int32, device=device),
            torch.zeros((64, b), dtype=torch.int32, device=device))


def segments(b: int, nb: int, sms: int):
    """(seg_tiles, nseg): how the kernel cuts rows of nb pixels, B at a
    time, on a card of ``sms`` SMs: into nseg segments of seg_tiles whole
    tiles of SEG_TILE pixels (the last may be short), as few tiles a
    segment as give the grid about BLOCKS_PER_SM blocks an SM."""
    tiles = -(-nb // SEG_TILE)
    per_row = min(tiles, max(1, -(-BLOCKS_PER_SM * sms // b)))
    seg_tiles = -(-tiles // per_row)
    return seg_tiles, -(-tiles // seg_tiles)


def encode_fields_planes_reference(packed, n_px, channels: int, prev_in,
                                   run_in, seen_in):
    """Plain version of E1: the JAX package's _encode_fields with its
    carries, over every row at once.  Same arguments and results as
    encode_fields_planes, carries given."""
    b, nb = packed.shape
    dev = packed.device
    idx = torch.arange(nb, dtype=torch.int32, device=dev)[None, :]
    valid = idx < n_px[:, None]
    run0 = run_in[:, None]
    prev = torch.cat([prev_in[:, None], packed[:, :-1]], dim=1)
    eq_raw = packed == prev
    noneq = valid & ~eq_raw

    # cnt = the run counter after each pixel; the carried run is a streak
    # of run0 equal pixels just before position 0
    last_noneq = torch.cummax(torch.where(noneq, idx, -(run0 + 1)),
                              dim=1).values
    cnt = idx - last_noneq
    hit62 = eq_raw & valid & (cnt % 62 == 0)
    cnt_prev = torch.cat([run0, cnt[:, :-1]], dim=1)
    eq_prev = torch.cat([run0 > 0, eq_raw[:, :-1]], dim=1)
    pend = torch.where(eq_prev, cnt_prev % 62, 0)  # pending run before i
    flush = noneq & (pend > 0)

    h = hash6(packed)
    table_val = _last_same_hash_value(packed, h, noneq, seen_in.T)
    own_len, own = op_bytes(packed, prev, noneq, table_val, h, channels)
    run_byte = torch.where(hit62, TAG_RUN | 61, TAG_RUN | ((pend - 1) & 0x3F))
    tlo, thn = pack_templates(own_len, own, hit62 | flush, run_byte)

    # the run counter after each block's last valid pixel (0 where none)
    first = torch.arange(0, nb, BLK, dtype=torch.int32, device=dev)[None, :]
    last = torch.minimum(n_px[:, None], first + BLK) - 1
    run_at = torch.where(eq_raw, cnt % 62, 0)
    run_out = torch.where(last >= first, torch.gather(
        run_at, 1, last.clamp(min=0).to(torch.int64)), 0)

    # each slot's last writer: the last differing pixel of its hash
    pos1 = torch.where(noneq, idx + 1, 0)
    jb = torch.zeros((b, 64), dtype=torch.int32, device=dev).scatter_reduce(
        1, h.to(torch.int64), pos1, "amax")
    vals = torch.gather(packed, 1, (jb - 1).clamp(min=0).to(torch.int64))
    seen_out = torch.where(jb > 0, vals, seen_in.T).T.contiguous()
    return tlo, thn, run_out.to(torch.int32), seen_out


def encode_fields_planes(packed, n_px, channels: int, prev_in=None,
                         run_in=None, seen_in=None):
    """The encoder's field pass over rows of pixel words.

    packed: (B, Nb) int32, Nb a multiple of 64; n_px: (B,) int32 valid
    pixels per row; channels: 3 or 4 (RGBA ops only for 4); prev_in (B,),
    run_in (B,) (0..61) and seen_in (64, B) int32: the state carried into
    each row, by default the start of an image (start_state).
    Returns (tlo (B, Nb), thn (B, Nb), run_out (B, ceil(Nb / 2048)),
    seen_out (64, B)), int32: run_out[:, k] is the run counter after the
    last valid pixel of pixels [2048 k, 2048 (k + 1)) (0 where there is
    none; at the block of pixel n_px - 1 it is the row's trailing run),
    seen_out the table after the row's last valid pixel.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    each row cut as ``segments`` says."""
    b, nb = packed.shape
    dev = packed.device
    if prev_in is None or run_in is None or seen_in is None:
        start = start_state(b, dev)
        prev_in, run_in, seen_in = (s if x is None else x for s, x in
                                    zip(start, (prev_in, run_in, seen_in)))
    if dev.type == "cpu":
        return encode_fields_planes_reference(packed, n_px, channels,
                                              prev_in, run_in, seen_in)
    if nb % TILE:
        raise ValueError(f"row width {nb} is not a multiple of {TILE}")
    if channels not in (3, 4):
        raise ValueError(f"channels must be 3 or 4, got {channels}")
    kernels.check(packed, "packed", torch.int32, (b, nb), dev)
    kernels.check(n_px, "n_px", torch.int32, (b,), dev)
    kernels.check(prev_in, "prev_in", torch.int32, (b,), dev)
    kernels.check(run_in, "run_in", torch.int32, (b,), dev)
    kernels.check(seen_in, "seen_in", torch.int32, (64, b), dev)
    tlo = torch.empty_like(packed)
    thn = torch.empty_like(packed)
    run_out = torch.empty((b, -(-nb // BLK)), dtype=torch.int32, device=dev)
    seen_out = torch.empty_like(seen_in)
    if b and nb:
        seg_tiles, nseg = segments(
            b, nb, torch.cuda.get_device_properties(dev).multi_processor_count)
        summary = torch.empty((b, nseg - 1, SUM_COLS), dtype=torch.int32,
                              device=dev)
        kernels.launch(
            "fields", "qk_fields", dev, packed.data_ptr(), n_px.data_ptr(),
            prev_in.data_ptr(), run_in.data_ptr(), seen_in.data_ptr(),
            tlo.data_ptr(), thn.data_ptr(), run_out.data_ptr(),
            seen_out.data_ptr(), summary.data_ptr(), b, nb, channels,
            seg_tiles)
    return tlo, thn, run_out, seen_out
