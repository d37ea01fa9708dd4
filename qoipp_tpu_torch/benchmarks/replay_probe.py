#!/usr/bin/env python
"""The replay chain's class probe: K1 and K5 in ns a row, on rows of one
class and on the rows the main path gives them.

    python -m qoipp_tpu_torch.benchmarks.replay_probe [--runs 5]

K1 (``replay_batch_carry``) runs at B = 16 lanes x C = 277,888 rows, the
batch RGB cell's shape (16 x 1920x1088, seed 0, qb rows a lane); K5
(``replay_batch_summary``) at B = 96 x C = 12,288, one fixpoint round of
the split sparse cell (4096x4096 RGB, ``make_image(seed=3)``, 96 lanes,
the chunk domain).  Each kernel replays five inputs of that shape:
  nop   every row NOP (class 0): no row changes the state;
  seta  every row SETA with a random pixel: the value needs no state;
  add   every row ADD with a random delta: the value needs prev;
  idx   every row IDX of a random slot: the value needs the table;
  rows  the cell's own rows (BatchPipeline.replay_inputs, or the split
        decoder's lane_rows with the round-0 guess as the carry).
Every synthetic row is a state row, so its ns a row is the chain's step;
on the corpus rows the chain walks only the state rows (classes 1-4 and
resets) of the longest lane, which the report counts.  Each input's
first CHECK_ROWS rows are held against the plain version, bit-exact,
before it is timed (CUDA events, 3 warmups, ``--runs`` timed calls).
The probe ends with the card's dependent-issue latency and SM clock
(``chain_latency``), the two numbers that turn ``chain_depth``, the
longest chain of dependent operations the replay function needs, into
the chain bound.

``--sass FILE`` also writes the SASS of the two replay kernels and of the
latency probe, from ``cuobjdump -sass`` of the built library: the chain
thread's loop gives this design's dependent instructions a state row
(PERF.md).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from . import timed_ms
from .. import kernels, oracle
from ..common import Channels, Desc
from ..convert import resolve_device
from ..kernels.selfcheck import max_abs_err
from ..models import split
from ..models.pipeline import BatchPipeline
from ..ops import probes
from ..ops import replay_kernel as rk
from ..utils.corpus import make_corpus, make_image

K1_SHAPE = (16, 1920, 1088, 0)  # images, width, height, corpus seed
K5_SIDE, K5_LANES, K5_SEED = 4096, 96, 3
CLASSES = ("nop", "seta", "add", "idx")
CHECK_ROWS = 256  # rows of each input held against the plain version
CHAIN_ROUNDS = 1 << 15  # the latency probe's 2^22 instructions, ~11 ms
# dependent 32-bit integer instructions a state row's value needs after
# what it reads, the fewest the function allows: SETA none (val is the
# pixel); SETC one (val merged with prev's alpha); ADD two (an add, which
# carries across channels, and at least one operation that undoes that);
# IDX one after the row that last wrote its slot (the entry selected)
CHAIN_OPS = {rk.CLS_SETA: 0, rk.CLS_SETC: 1, rk.CLS_ADD: 2, rk.CLS_IDX: 1}


def k1_rows(dev):
    """The batch RGB cell's replay rows: (meta, val) (qb, 16) int32."""
    b, w, h, seed = K1_SHAPE
    _, _, blobs = make_corpus(b, w, h, seed=seed, channels=3)
    desc = Desc(w, h, Channels.RGB)
    pipe = BatchPipeline(desc, max_stream_len=max(x.size for x in blobs),
                         device=dev)
    streams, sizes = pipe.pack_streams(blobs)
    meta, val, _ = pipe.replay_inputs(streams, sizes)
    return meta, val


def k5_rows(dev):
    """One fixpoint round of the split sparse cell: (meta, val) (qc, 96)
    int32 rows and the round-0 guess (prev (1, 96), seen (64, 96))."""
    desc = Desc(K5_SIDE, K5_SIDE, Channels.RGB)
    blob, _ = oracle.encode(make_image(K5_SIDE, K5_SIDE, seed=K5_SEED), desc)
    dec = split.SplitDecoder(lanes=K5_LANES, device=dev)
    (regions, _, chunks_sizes, px_budgets, _, _, _, qb, n_cap,
     qc) = dec.stage_plan(dec.plan_and_pack([blob]))
    meta, val, _ = split.lane_rows(regions, chunks_sizes, px_budgets, qb,
                                   n_cap, qc)
    return meta, val, split.initial_guess(meta.shape[1], dev)


def class_rows(cls: str, c: int, b: int, dev, seed: int = 0):
    """(C, B) int32 rows all of one class, values and slots from ``seed``."""
    rng = np.random.default_rng(seed)
    val = rng.integers(0, 1 << 32, (c, b), dtype=np.uint64).astype(np.uint32)
    if cls == "nop":
        meta = np.zeros((c, b), np.uint32)
    elif cls == "idx":
        meta = (rk.CLS_IDX | rng.integers(0, 64, (c, b)) << 3).astype(
            np.uint32)
    else:
        meta = np.full((c, b), rk.CLS_SETA if cls == "seta" else rk.CLS_ADD,
                       np.uint32)
    return tuple(torch.from_numpy(x.view(np.int32)).to(dev)
                 for x in (meta, val))


def state_rows(meta) -> int:
    """The state rows (classes 1-4, or a reset) of the longest lane."""
    cls = meta & 7
    state = ((cls >= rk.CLS_SETA) & (cls <= rk.CLS_IDX)) | (
        ((meta >> 9) & 1) == 1)
    return int(state.sum(dim=0).max()) if meta.numel() else 0


def chain_depth(meta, emits) -> int:
    """The longest chain of dependent operations that the replay function
    needs on any lane, at CHAIN_OPS a state row: a row's value is ready
    CHAIN_OPS after what it reads, prev (SETC, ADD) or the value of the
    row that last wrote its slot (IDX; the table's hash slots are those of
    the emits).  The carry and a reset's start state are ready at 0.  Rows
    (C, B), meta and the emits the function gave on them."""
    m = meta.contiguous().cpu().numpy().view(np.uint32)
    e = emits.contiguous().cpu().numpy().view(np.uint32)
    c, b = m.shape
    cls, rst, arg = m & 7, (m >> 9) & 1, (m >> 3) & 63
    slot = (e.view(np.uint8).reshape(c, b, 4).astype(np.int64)
            @ np.array([3, 5, 7, 11])) & 63
    state = ((cls >= rk.CLS_SETA) & (cls <= rk.CLS_IDX)) | (rst == 1)
    best = 0
    for lane in range(b):
        rows = np.flatnonzero(state[:, lane])
        d, ready = 0, [0] * 64
        for k, r, a, h in zip(*(x[rows, lane].tolist()
                                for x in (cls, rst, arg, slot))):
            if r:
                d, ready = 0, [0] * 64
            if k == rk.CLS_IDX:
                d = ready[a] + CHAIN_OPS[k]
            elif k in CHAIN_OPS:
                d = (d if k != rk.CLS_SETA else 0) + CHAIN_OPS[k]
            else:
                continue  # a reset on a row that updates nothing
            ready[h] = d
            best = max(best, d)
    return best


def chain_latency(dev) -> tuple:
    """(SM cycles a dependent integer instruction, SM MHz) on the card,
    from ``probes.dep_chain`` (the mean of an add and a xor, each waiting
    on the one before): its result checked on a short chain, then the
    second of two runs of CHAIN_ROUNDS."""
    _, _, x = probes.dep_chain(dev, 4)
    if x != probes.dep_chain_reference(4):
        raise RuntimeError("dep_chain disagrees with its plain version")
    for _ in range(2):
        cycles, ns, _ = probes.dep_chain(dev, CHAIN_ROUNDS)
    ops = CHAIN_ROUNDS * probes.CHAIN_UNROLL * probes.CHAIN_STEP_OPS
    return cycles / ops, cycles / ns * 1e3


def probe(kernel: str, inputs: dict, carry, runs: int) -> list:
    """Time ``kernel`` ("replay" or "replay_summary") on each named (meta,
    val) input of ``inputs`` from ``carry`` (prev (1, B), seen (64, B)),
    after holding its first CHECK_ROWS rows against the plain version.
    Returns one row per input."""
    fn, ref = ((rk.replay_batch_carry, rk.replay_batch_carry_reference)
               if kernel == "replay" else
               (rk.replay_batch_summary, rk.replay_batch_summary_reference))
    out = []
    for name, (meta, val) in inputs.items():
        c, b = meta.shape
        pm, pv = meta[:CHECK_ROWS], val[:CHECK_ROWS]
        err = max(max_abs_err(g, w) for g, w in
                  zip(fn(pm, pv, *carry), ref(pm, pv, *carry)))
        if err:
            raise RuntimeError(f"{kernel} on {name} rows disagrees with its "
                               f"plain version: max_abs_err {err}")
        ms = timed_ms(lambda: fn(meta, val, *carry), runs=runs) if runs \
            else None
        n_state = state_rows(meta)
        row = dict(kernel=kernel, rows=name, C=c, B=b, state_rows=n_state,
                   max_abs_err=err, ms=ms,
                   ns_per_row=None if ms is None else ms / c * 1e6,
                   ns_per_state_row=(None if ms is None or not n_state
                                     else ms / n_state * 1e6))
        out.append(row)
        timing = ("not timed" if ms is None else
                  f"{ms:.4f} ms = {row['ns_per_row']:.2f} ns/row"
                  + (f", {row['ns_per_state_row']:.2f} ns/state row"
                     if n_state else ""))
        print(f"replay_probe: {kernel} {name:>4} (C={c}, B={b}, "
              f"{n_state} state rows on the longest lane): {timing}",
              flush=True)
    return out


def run_probe(k1_meta, k1_val, k5_meta, k5_val, k5_carry, dev,
              runs: int) -> list:
    """The class probe of both kernels: the four classes at each corpus
    input's shape, then the corpus rows themselves."""
    rows = []
    for kernel, meta, val, carry in (
            ("replay", k1_meta, k1_val, rk.initial_state(k1_meta.shape[1],
                                                         dev)),
            ("replay_summary", k5_meta, k5_val, k5_carry)):
        c, b = meta.shape
        inputs = {cls: class_rows(cls, c, b, dev, seed=i)
                  for i, cls in enumerate(CLASSES)}
        inputs["rows"] = (meta, val)
        rows += probe(kernel, inputs, carry, runs)
        del inputs
    return rows


def sass() -> str:
    """The SASS of the replay kernels (K1 and K5) and of the latency probe
    in the built library."""
    return kernels.sass("replay_kernel", "dep_chain")


def main(argv=None, device=None) -> list:
    """Make both cells' rows and run the class probe.  Returns its rows;
    raises if a kernel disagrees with its plain version."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5,
                    help="timed calls per input; 0 checks parity only")
    ap.add_argument("--sass", type=Path, default=None,
                    help="also write the replay kernels' SASS to this file")
    args = ap.parse_args(argv)
    if args.sass is not None:
        args.sass.write_text(sass())
    dev = resolve_device(device)
    if args.runs and dev.type != "cuda":
        raise ValueError("timing needs a CUDA device: pass --runs 0")
    k1_meta, k1_val = k1_rows(dev)
    k5_meta, k5_val, k5_carry = k5_rows(dev)
    rows = run_probe(k1_meta, k1_val, k5_meta, k5_val, k5_carry, dev,
                     args.runs)
    if args.runs:
        lat, mhz = chain_latency(dev)
        print(f"replay_probe: a dependent integer instruction takes "
              f"{lat:.3f} cycles at {mhz:.0f} MHz", flush=True)
    return rows


if __name__ == "__main__":
    main()
