#!/usr/bin/env python
"""E8, E9 and the round-2 design probes on the card.

Counterpart of the repository's ``benchmarks/profile_r2.py``, which
measured on the TPU the quantities behind the expansion and emission
redesign.  Here, every time by CUDA events (``--runs`` timed calls after
three warmups):
  1. the stage profile of BatchPipeline decode (regions, boundary pass,
     dense fields, K1 replay, K2 placement, and the whole decode_packed);
  2. torch's scatter-add and scatter-set rates at 1-16 M elements (int32
     words: torch has no uint32 add);
  3. E8, the per-block overhead: x + 1 over (steps, 8, 128) words, one
     block per step (ops/probes.grid_step_probe);
  4. the int32 cumsum rate over (B, n_cap);
  5. the chunk statistics of the batch;
and last E9, the one-hot placement probe as a scatter-add, K = 2048
targets in S = 17 stripes of 128 bins per block, 2,048 blocks
(ops/probes.onehot_place).  E8 and E9 are held against their plain
versions (E9 within 1e-6) before they are timed, and timed beside them and
beside the one torch call that computes each (``x + 1``,
``zeros.scatter_add_``).

    python -m qoipp_tpu_torch.benchmarks.profile_r2 [--batch 128] [--runs 6]

``--runs 0`` checks parity alone (it also runs on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import check_timing, timed_ms
from ..convert import resolve_device
from ..kernels.selfcheck import TOLERANCE, max_abs_err
from ..models.pipeline import BatchPipeline
from ..ops import probes
from .stages import decode_stages
from ..utils.corpus import make_corpus

W, H = 1920, 1088  # the script's image size
STEPS = (4096, 16384, 65536)  # E8's grid steps
K, NBLK = 2048, 2048  # E9's targets per block and blocks
SCATTER_SIZES = (1 << 20, 1 << 22, 1 << 23, 1 << 24)


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _time(fn, runs):
    return timed_ms(fn, runs=runs) if runs else None


def _ms(t) -> str:
    return "not timed" if t is None else f"{t:.4f} ms"


def stage_profile(pipe, streams, sizes, runs: int) -> dict:
    """Probes 1 and 5: ms per decode stage and the batch's chunk counts.
    The stages' output must equal decode_packed's."""
    def regions_of():
        regions = streams[:, 14:]
        q = torch.arange(regions.shape[1], dtype=torch.int32,
                         device=streams.device)[None, :]
        return torch.where(q < (sizes - 14)[:, None], regions, 0)

    st, info, placed = decode_stages(regions_of(), sizes - 22, pipe.n_px,
                                     pipe.qb, pipe.n_cap)
    stages = dict(regions=regions_of, **st, decode_packed=lambda:
                  pipe.decode_packed(streams, sizes))
    _expect(torch.equal(placed, stages["decode_packed"]()),
            "the decode stages differ from decode_packed")
    ms = {k: _time(fn, runs) for k, fn in stages.items()}
    tc = info["total_chunks"].cpu().numpy()
    print(f"[stage B={streams.shape[0]}] "
          + " ".join(f"{k}={_ms(v)}" for k, v in ms.items()))
    print(f"[chunks] qb={pipe.qb} total_chunks min={tc.min()} "
          f"max={tc.max()} mean={tc.mean():.0f}  (n_px={pipe.n_px})")
    return dict(stage_ms=ms, qb=pipe.qb, chunks=dict(
        min=int(tc.min()), max=int(tc.max()), mean=float(tc.mean())))


def scatter_rates(b: int, n_cap: int, dev, runs: int) -> list:
    """Probe 2: torch's scatter-add (index_add_) and scatter-set
    (index_put_) of int32 words at sorted indices into b rows of n_cap + 1,
    ms and ns per element."""
    n_out = b * (n_cap + 1)
    out = []
    for n_el in SCATTER_SIZES:
        per = n_el // b
        idx = np.sort(np.random.default_rng(0).integers(0, n_cap, (b, per)),
                      axis=1) + np.arange(b)[:, None] * (n_cap + 1)
        idx = torch.from_numpy(idx.reshape(-1)).to(dev)
        vals = torch.randint(-(1 << 31), 1 << 31, (b * per,),
                             dtype=torch.int32, device=dev)
        add = _time(lambda: torch.zeros(n_out, dtype=torch.int32, device=dev)
                    .index_add_(0, idx, vals), runs)
        put = _time(lambda: torch.zeros(n_out, dtype=torch.int32, device=dev)
                    .index_put_((idx,), vals), runs)
        row = dict(elements=b * per, add_ms=add, set_ms=put)
        if runs:
            print(f"[scatter n={n_el >> 20}M] add={add:.4f} ms "
                  f"({add * 1e6 / (b * per):.3f} ns/el)  set={put:.4f} ms "
                  f"({put * 1e6 / (b * per):.3f} ns/el)")
        out.append(row)
    return out


def cumsum_rate(b: int, n_cap: int, dev, runs: int):
    """Probe 4: int32 cumsum over (b, n_cap) words of 0..254, ms."""
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.randint(0, 255, (b, n_cap), dtype=torch.int32, device=dev,
                        generator=gen)
    ms = _time(lambda: torch.cumsum(big, dim=1, dtype=torch.int32), runs)
    if runs:
        print(f"[cumsum ({b}, {n_cap})] {ms:.4f} ms "
              f"({ms * 1e6 / (b * n_cap):.4f} ns/el)")
    return ms


def grid_steps(dev, runs: int, steps=STEPS) -> list:
    """Probe 3, E8: x + 1 over (steps, 8, 128) zeros, one block per step,
    against its plain version; kernel, plain and library (``x + 1``)
    times."""
    out = []
    for n in steps:
        x = torch.zeros((n,) + probes.STEP_SHAPE, dtype=torch.int32,
                        device=dev)
        y = probes.grid_step_probe(x)
        err = max_abs_err(y, probes.grid_step_reference(x))
        _expect(err == 0 and bool((y == 1).all()),
                f"grid_step disagrees with its plain version at {n} steps")
        row = dict(steps=n, max_abs_err=err,
                   ms=_time(lambda: probes.grid_step_probe(x), runs),
                   plain_ms=_time(lambda: probes.grid_step_reference(x), runs),
                   library_ms=_time(lambda: x + 1, runs))
        if runs:
            print(f"[grid overhead steps={n}] {row['ms']:.4f} ms "
                  f"({row['ms'] * 1e6 / n:.1f} ns/step); x + 1 "
                  f"{row['library_ms']:.4f} ms")
        out.append(row)
    return out


def onehot_inputs(dev, nblk: int = NBLK, k: int = K):
    """E9's inputs, the script's byte for byte: targets sorted per block,
    values in [0, 1)."""
    tt = np.random.default_rng(1).integers(0, probes.S * 128,
                                           (nblk, k)).astype(np.int32)
    tt.sort(axis=1)
    vv = np.random.default_rng(2).random((nblk, k)).astype(np.float32)
    return torch.from_numpy(tt).to(dev), torch.from_numpy(vv).to(dev)


def onehot(dev, runs: int, nblk: int = NBLK) -> dict:
    """E9 against its plain version (to TOLERANCE), then kernel, plain and
    library (``zeros.scatter_add_``) times."""
    t, v = onehot_inputs(dev, nblk)
    err = float((probes.onehot_place(t, v)
                 - probes.onehot_place_reference(t, v)).abs().max())
    _expect(err <= TOLERANCE["onehot_place"],
            f"onehot_place disagrees with its plain version: {err}")
    t64 = t.long()
    nbins = probes.S * 128
    row = dict(blocks=nblk, k=K, s=probes.S, max_abs_err=err,
               ms=_time(lambda: probes.onehot_place(t, v), runs),
               plain_ms=_time(lambda: probes.onehot_place_reference(t, v),
                              runs),
               library_ms=_time(lambda: torch.zeros(
                   (nblk, nbins), dtype=torch.float32, device=dev)
                   .scatter_add_(1, t64, v), runs))
    print(f"[placement scatter K={K} S={probes.S} blocks={nblk}] "
          f"max_abs_err {err:.3g}"
          + ("" if not runs else
             f"; {row['ms']:.4f} ms ({row['ms'] * 1e6 / nblk:.1f} ns/block, "
             f"{row['ms'] * 1e6 / (nblk * K):.3f} ns/input-row); plain "
             f"{row['plain_ms']:.4f} ms, scatter_add_ "
             f"{row['library_ms']:.4f} ms"))
    return row


def run_probes(pipe, streams, sizes, dev, runs: int, steps=STEPS,
               nblk: int = NBLK) -> dict:
    """Every probe in the script's order, on one BatchPipeline batch
    (streams, sizes on ``dev``).  Returns the results."""
    out = stage_profile(pipe, streams, sizes, runs)
    b = streams.shape[0]
    out["scatter"] = scatter_rates(b, pipe.n_cap, dev, runs) if runs else []
    out["cumsum_ms"] = cumsum_rate(b, pipe.n_cap, dev, runs)
    out["grid_step"] = grid_steps(dev, runs, steps)
    out["onehot_place"] = onehot(dev, runs, nblk)
    return out


def main(argv=None, device=None) -> dict:
    """Make the script's corpus (--batch synthetic RGB images) and run
    every probe.  Returns the results; raises if a kernel disagrees."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--steps", type=int, nargs="+", default=list(STEPS))
    ap.add_argument("--blocks", type=int, default=NBLK)
    ap.add_argument("--runs", type=int, default=6,
                    help="timed calls per probe; 0 checks parity only")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    check_timing(dev, args.runs)
    desc, _, blobs = make_corpus(args.batch, args.width, args.height)
    pipe = BatchPipeline(desc, max_stream_len=max(x.size for x in blobs),
                         device=dev)
    streams, sizes = (torch.from_numpy(x).to(dev)
                      for x in pipe.pack_streams(blobs))
    return run_probes(pipe, streams, sizes, dev, args.runs, args.steps,
                      args.blocks)


if __name__ == "__main__":
    main()
