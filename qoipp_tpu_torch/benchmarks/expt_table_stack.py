#!/usr/bin/env python
"""The stacked-plane table fill on the card, beside the shipped table scan.

Counterpart of the repository's ``benchmarks/expt_table_stack.py``, which
tried on the TPU a cheaper form of the encoder's same-hash table scan
(for each position, the word of the last earlier differing pixel with its
hash, in its stream): per TILE-pixel tile a pairwise search inside the
tile and a 64-slot summary of the tile's last writers, then a log-shift
overwrite fill of the summaries across tiles with (value, key) stacked in
one (s, 128) plane, so that each fill step is one concat and one select;
key = seg + 1 (0 unwritten) folds the segment test into the written test.
Both of the script's variants are here in torch, batched over rows:
``_last_same_hash_value_seg_stacked`` (packed lanes, any ``tile``) and
``_last_same_hash_value_stacked`` (one stream a row, an optional incoming
table), with ``torch.gather`` for the script's one-hot masked sums.  The
port ships another design, a stable sort by hash
(ops/encode._last_same_hash_value and _last_same_hash_value_seg): each
variant is held equal to it on the script's cases (``_rand_case``, a
byte-equal copy) and then timed beside it at the script's shapes, 12
lanes x 458,752 rows (20 segments) and 32 x 524,288 rows: CUDA-event ms,
device ms and launches (torch.profiler).

    python -m qoipp_tpu_torch.benchmarks.expt_table_stack
    python -m qoipp_tpu_torch.benchmarks.expt_table_stack --device cpu --runs 0
"""

from __future__ import annotations

import numpy as np
import torch

from . import stages as S
from ..ops import encode as enc_ops
from ..ops.encode import TILE

SEG_CASES = ((TILE, 1), (4 * TILE, 3), (64 * TILE, 9), (1024 * TILE, 40))
PLAIN_SIZES = (TILE, 4 * TILE, 64 * TILE, 1024 * TILE)
SEG_SHAPE = (12, 448 * 1024, 20)  # lanes, rows, segments
PLAIN_SHAPE = (32, 512 * 1024)  # rows, row length


def _pairs(hh, ne, tile: int):
    """(j, pair): pair[..., i, j] where j < i in one tile, pixel j differs
    and its hash is pixel i's; hh, ne (B, s, tile)."""
    j = torch.arange(tile, dtype=torch.int32, device=hh.device)
    return j, (hh[..., None, :] == hh[..., :, None]) & (
        j[None, :] < j[:, None]) & ne[..., None, :]


def _local(pair, ph, j):
    """(found, word): each pixel's last pair partner in its tile."""
    lastj = torch.where(pair, j, -1).amax(dim=-1)
    return lastj >= 0, torch.gather(ph, -1, lastj.clamp(min=0).long())


def _last_writers(hh, ne, j):
    """(B, s, 64) int64: each slot's last differing writer in the tile, -1
    if none."""
    slots = torch.arange(64, dtype=torch.int32, device=hh.device)
    covers = (hh[..., None, :] == slots[:, None]) & ne[..., None, :]
    return torch.where(covers, j, -1).amax(dim=-1).long()


def _fill(st):
    """Log-shift overwrite fill of (B, s, 128) stacked (value, key) planes
    along s: a row keeps a slot its key marks written, else takes the one
    k rows up; then shifted down a row (the exclusive prefix)."""
    s = st.shape[1]
    k = 1
    while k < s:
        pz = torch.cat([torch.zeros_like(st[:, :k]), st[:, :-k]], dim=1)
        w = st[..., 64:] > 0
        st = torch.where(torch.cat([w, w], dim=-1), st, pz)
        k *= 2
    return torch.cat([torch.zeros_like(st[:, :1]), st[:, :-1]], dim=1)


def _last_same_hash_value_seg_stacked(packed, h, noneq, seg, tile=TILE):
    """The script's segmented candidate: packed, h, noneq, seg (B, N)
    (N % tile == 0, seg nondecreasing along each row) -> (B, N) int32,
    equal to ops/encode._last_same_hash_value_seg."""
    b, n = packed.shape
    s = n // tile
    ph = packed.reshape(b, s, tile)
    hh = h.reshape(b, s, tile).to(torch.int32)
    ne = noneq.reshape(b, s, tile)
    key = (seg.reshape(b, s, tile) + 1).to(torch.int32)
    j, pair = _pairs(hh, ne, tile)
    found, local = _local(pair & (key[..., None, :] == key[..., :, None]),
                          ph, j)
    tj = _last_writers(hh, ne, j)
    written = tj >= 0
    t_val = torch.where(written, torch.gather(ph, -1, tj.clamp(min=0)), 0)
    t_key = torch.where(written, torch.gather(key, -1, tj.clamp(min=0)), 0)
    inc = _fill(torch.cat([t_val, t_key], dim=-1))
    px_v = torch.gather(inc[..., :64], -1, hh.long())
    px_k = torch.gather(inc[..., 64:], -1, hh.long())
    # an entry applies iff written in this pixel's segment: key == seg + 1
    fallback = torch.where(px_k == key, px_v, 0)
    return torch.where(found, local, fallback).reshape(b, n)


def _last_same_hash_value_stacked(packed, h, noneq, incoming=None):
    """The script's plain candidate: (B, N) rows (N % TILE == 0), incoming
    (64,) or (B, 64) or None -> (B, N) int32, equal to
    ops/encode._last_same_hash_value."""
    b, n = packed.shape
    s = n // TILE
    ph = packed.reshape(b, s, TILE)
    hh = h.reshape(b, s, TILE).to(torch.int32)
    ne = noneq.reshape(b, s, TILE)
    j, pair = _pairs(hh, ne, TILE)
    found, local = _local(pair, ph, j)
    tj = _last_writers(hh, ne, j)
    written = tj >= 0
    t_val = torch.where(written, torch.gather(ph, -1, tj.clamp(min=0)), 0)
    inc = _fill(torch.cat([t_val, written.to(torch.int32)], dim=-1))
    if incoming is None:
        incoming = torch.zeros(64, dtype=torch.int32, device=packed.device)
    table = torch.where(inc[..., 64:] > 0, inc[..., :64],
                        incoming.reshape(-1, 1, 64))
    return torch.where(found, local,
                       torch.gather(table, -1, hh.long())).reshape(b, n)


def _rand_case(rng, n, n_seg):
    """A segmented lane of low-entropy pixels whose hash slots collide
    across segment edges; the script's generator, byte for byte (numpy:
    packed and h uint32, noneq bool, seg int32)."""
    vals = rng.integers(0, 6, size=(n, 4)).astype(np.uint32)
    packed = (vals[:, 0] | (vals[:, 1] << 8) | (vals[:, 2] << 16)
              | (vals[:, 3] << 24))
    noneq = rng.random(n) < 0.7
    cuts = np.sort(rng.choice(n, size=n_seg - 1, replace=False))
    seg = np.zeros(n, np.int32)
    for c in cuts:
        seg[c:] += 1
    h = (3 * vals[:, 0] + 5 * vals[:, 1] + 7 * vals[:, 2]
         + 11 * vals[:, 3]) % 64
    return packed, h.astype(np.uint32), noneq, seg


def _incoming(rng):
    """The script's incoming table: 64 low-entropy words."""
    return (rng.integers(0, 6, size=(64, 4)).astype(np.uint32)
            @ np.array([1, 1 << 8, 1 << 16, 1 << 24], np.uint32))


def _rows(cases, dev):
    """Stack _rand_case tuples into (B, N) tensors (words as int32)."""
    out = []
    for x in zip(*cases):
        a = np.stack(x)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(dev))
    return out


def hold(dev, rng) -> None:
    """Both candidates (seg at tile 64 and 32) against the shipped scans
    on the script's cases, in the script's order of draws."""
    for n, n_seg in SEG_CASES:
        args = _rows([_rand_case(rng, n, n_seg)], dev)
        want = enc_ops._last_same_hash_value_seg(*args)
        for tile in (TILE, 32):
            S.expect(torch.equal(
                _last_same_hash_value_seg_stacked(*args, tile=tile), want),
                f"seg stacked (tile {tile}) differs at n={n} n_seg={n_seg}")
    for n in PLAIN_SIZES:
        pk, h, nq = _rows([_rand_case(rng, n, 1)[:3]], dev)
        inc = torch.from_numpy(_incoming(rng).view(np.int32)).to(dev)
        for incoming in (None, inc):
            S.expect(torch.equal(
                _last_same_hash_value_stacked(pk, h, nq, incoming),
                enc_ops._last_same_hash_value(pk, h, nq, incoming)),
                f"plain stacked differs at n={n}")
    print(f"correctness: identical on {len(SEG_CASES)} segmented cases "
          f"(tile 64 and 32) and {len(PLAIN_SIZES)} plain sizes (with and "
          "without an incoming table)")


def timed(dev, rng, runs: int, seg_shape=SEG_SHAPE,
          plain_shape=PLAIN_SHAPE) -> dict:
    """The shipped scans and the candidates at the script's shapes,
    measured (stages.measure), each candidate held first."""
    lanes, n, n_seg = seg_shape
    args = _rows([_rand_case(rng, n, n_seg) for _ in range(lanes)], dev)
    b2, n2 = plain_shape
    pargs = _rows([_rand_case(rng, n2, 1)[:3] for _ in range(b2)], dev)
    calls = {
        "seg shipped": lambda: enc_ops._last_same_hash_value_seg(*args),
        "seg stacked": lambda: _last_same_hash_value_seg_stacked(*args),
        "seg stacked t32": lambda: _last_same_hash_value_seg_stacked(
            *args, tile=32),
        "plain shipped": lambda: enc_ops._last_same_hash_value(*pargs),
        "plain stacked": lambda: _last_same_hash_value_stacked(*pargs)}
    for cand, base in (("seg stacked", "seg shipped"),
                       ("seg stacked t32", "seg shipped"),
                       ("plain stacked", "plain shipped")):
        S.expect(torch.equal(calls[cand](), calls[base]()),
                 f"{cand} differs from {base} at the timed shape")
    out = {}
    for name, fn in calls.items():
        out[name] = r = S.measure(fn, runs)
        shape = (f"L={lanes} N={n}" if name.startswith("seg")
                 else f"B={b2} N={n2}")
        print(f"{name:>16}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
              f"ms, {r['launches']:g} launches ({shape})")
    return out


def main(argv=None, device=None) -> dict:
    """Hold both candidates on the script's cases, then time them beside
    the shipped scans.  Returns the rows."""
    ap = S.parser(__doc__)
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    rng = np.random.default_rng(7)
    hold(dev, rng)
    return timed(dev, rng, args.runs) if args.runs else {}


if __name__ == "__main__":
    main()
