#!/usr/bin/env python
"""The two-level boundary scan on the card, beside the shipped one.

Superseded: on CUDA tensors the shipped ``ops/boundary.chunk_starts_batch``
is now one kernel (csrc/boundary.cu, one launch a call), so this
experiment stays as an independent formulation that the card tests hold
against it, and is never wired in.

Counterpart of the repository's ``benchmarks/expt_boundary2l.py``.  The
plain ``ops/boundary.chunk_starts_batch_plain`` runs two BLOCK=128-step
loops (the block phase maps, then the byte replay) around a log-depth
compose across blocks: in torch each step is a few elementwise launches,
~900 in all, a large share of a decode's host time.  Phase maps over {0..4}
compose associatively, so each block's 128-step loop can itself be
hierarchical: M=16-step loops build micro maps, log2(128 / M) = 3 compose
levels merge a block's 8 micro maps, and the replay runs M steps from
each micro's entry phase: ~40 sequential steps in place of 256.  The
one-hot selects of the script's compose and apply are ``torch.gather``
here (one launch for five selects); the result is bit-identical by
construction, and this module holds it so on the script's adversarial
byte soup (``_rand_streams``, a byte-equal copy) and on a real batch's
regions before it times it beside the kernel and the plain loops:
CUDA-event ms, device ms and launches (torch.profiler) a call, at the
script's production shape (B=128 x 749,568 bytes: 4 soup streams tiled 32
times).

    python -m qoipp_tpu_torch.benchmarks.expt_boundary2l [--batch 128]
    python -m qoipp_tpu_torch.benchmarks.expt_boundary2l --device cpu --runs 0
"""

from __future__ import annotations

import numpy as np
import torch

from . import stages as S
from ..ops import boundary
from ..ops.boundary import BLOCK, chunk_len_of
from ..utils.corpus import make_corpus

M = 16  # micro-loop length
NM = BLOCK // M  # micro maps a block
QB = 749568 // BLOCK * BLOCK  # the script's production region width
PARITY_SHAPES = ((2, BLOCK), (3, 4 * BLOCK), (2, 37 * BLOCK))


def _compose(a, b_):
    """a then b, maps over {0..4} along dim 1: out[j] = b_[a[j]]."""
    return torch.gather(b_, 1, a)


def chunk_starts_batch_2l(regions):
    """Two-level chunk_starts_batch: (B, Qb) uint8, Qb % BLOCK == 0 ->
    (B, Qb) bool, bit-identical to the shipped scan."""
    b, qb = regions.shape
    if qb % BLOCK:
        raise ValueError(f"region width {qb} is not a multiple of {BLOCK}")
    nblk = qb // BLOCK
    k = nblk * NM
    dev = regions.device
    steps = (chunk_len_of(regions) - 1).reshape(b, k, M)  # uint8

    # A': each micro's map, an M-step loop over a (B, 5, K) uint8 carry
    micro = torch.arange(5, dtype=torch.uint8, device=dev)[
        None, :, None].expand(b, 5, k).clone()
    for t in range(M):
        micro = torch.where(micro > 0, micro - 1, steps[:, None, :, t])

    # A'': inclusive Hillis-Steele compose over each block's NM micros
    # (int64, gather's index type); the exclusive prefix is the result
    # shifted by one micro
    acc = micro.to(torch.int64).reshape(b, 5, nblk, NM)
    ident4 = torch.arange(5, dtype=torch.int64, device=dev)[
        None, :, None, None].expand(b, 5, nblk, NM)
    sh = 1
    while sh < NM:
        acc = _compose(torch.cat([ident4[..., :sh], acc[..., :-sh]], dim=3),
                       acc)
        sh *= 2
    pre = torch.cat([ident4[..., :1], acc[..., :-1]], dim=3).reshape(b, 5, k)

    # B: inclusive compose across blocks by log-doubling, then exclusive
    inc = acc[..., NM - 1]
    d = 1
    while d < nblk:
        inc = torch.cat([inc[:, :, :d], _compose(inc[:, :, :-d],
                                                 inc[:, :, d:])], dim=2)
        d *= 2
    entry_blk = torch.cat([torch.zeros((b, 1), dtype=torch.int64,
                                       device=dev),
                           inc[:, 0, :-1]], dim=1)  # phi enters block 0 at 0
    # each micro's entry phase: its exclusive prefix map at its block's
    entry = torch.gather(pre, 1, entry_blk.repeat_interleave(NM, dim=1)[
        :, None, :])[:, 0, :]

    # C': M-step replay from every micro's entry phase
    phases = torch.empty((b, k, M), dtype=torch.uint8, device=dev)
    phi = entry.to(torch.uint8)
    for t in range(M):
        phases[:, :, t] = phi
        phi = torch.where(phi > 0, phi - 1, steps[:, :, t])
    return phases.reshape(b, qb) == 0


def _rand_streams(rng, b, qb):
    """Byte soup with a realistic tag mix (every length class) and payload
    bytes that look like tags; the script's generator, byte for byte."""
    out = np.zeros((b, qb), np.uint8)
    for i in range(b):
        pos = 0
        buf = []
        while pos < qb:
            r = rng.random()
            if r < 0.35:
                buf.append(rng.integers(0, 0xC0))      # 1-byte
                pos += 1
            elif r < 0.55:
                buf += [0x80 | rng.integers(0, 64), rng.integers(0, 256)]
                pos += 2
            elif r < 0.8:
                buf += [0xFE, 0xFE, 0xFF, 0xC3]        # RGB w/ taggy payload
                pos += 4
            elif r < 0.9:
                buf += [0xFF, 0xFF, 0xFE, 0x80, 0xC0]  # RGBA taggy payload
                pos += 5
            else:
                buf.append(0xC0 | rng.integers(0, 62))  # RUN
                pos += 1
        out[i] = np.asarray(buf[:qb], np.uint8)
    return out


def hold(regions, what: str) -> None:
    """The two-level scan against the shipped one on regions."""
    S.expect(torch.equal(chunk_starts_batch_2l(regions),
                         boundary.chunk_starts_batch(regions)),
             f"the two-level scan differs from the shipped one on {what}")


def batch_regions(dev, b: int = 2, w: int = 64, h: int = 48):
    """A real batch's regions: make_corpus streams past their headers,
    zero-padded to a multiple of BLOCK."""
    _, _, blobs = make_corpus(b, w, h)
    qb = -(-max(x.size - 14 for x in blobs) // BLOCK) * BLOCK
    reg = np.zeros((b, qb), np.uint8)
    for i, x in enumerate(blobs):
        reg[i, : x.size - 14] = x[14:]
    return torch.from_numpy(reg).to(dev)


def timed(regions, runs: int) -> dict:
    """The shipped scan (the kernel on the card), its plain loops and the
    two-level scan on regions, measured (stages.measure)."""
    out = {}
    for name, fn in (("shipped", boundary.chunk_starts_batch),
                     ("plain", boundary.chunk_starts_batch_plain),
                     ("two-level", chunk_starts_batch_2l)):
        out[name] = S.measure(lambda fn=fn: fn(regions), runs)
        r = out[name]
        print(f"{name:>10}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} "
              f"ms, {r['launches']:g} launches (B={regions.shape[0]} "
              f"Qb={regions.shape[1]})")
    return out


def main(argv=None, device=None) -> dict:
    """Hold the two-level scan on the script's cases and a real batch, then
    time both at the production shape.  Returns the rows."""
    ap = S.parser(__doc__)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--qb", type=int, default=QB)
    args = ap.parse_args(argv)
    dev = S.device_of(args, device)
    rng = np.random.default_rng(11)
    for b, qb in PARITY_SHAPES:
        hold(torch.from_numpy(_rand_streams(rng, b, qb)).to(dev),
             f"({b}, {qb}) byte soup")
    hold(batch_regions(dev), "a make_corpus batch's regions")
    print(f"correctness: identical on {len(PARITY_SHAPES)} adversarial "
          "batches and a real batch")
    if not args.runs:
        return {}
    reg = torch.from_numpy(_rand_streams(rng, 4, args.qb)).to(dev)
    reg = reg.repeat(args.batch // 4, 1)
    hold(reg, "the production shape")
    return timed(reg, args.runs)


if __name__ == "__main__":
    main()
