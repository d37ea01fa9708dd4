"""What the stage profiles and the host-stage experiments share.

A stage profile cuts a codec path into stages, runs each once so that
every stage has the materialized outputs of the one before, requires the
last stage's output to equal the fused call's (and the oracle's), and
then times each stage alone: CUDA-event ms over ``runs`` calls after
three warmups, and by torch.profiler the device busy ms of a call and the
device operations it launched (kernels, copies and fills).  Stages a
profile marks as not on the port's path are timed but left out of the
stage sum.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from . import check_timing, timed_ms
from .. import oracle
from ..common import read_header
from ..convert import resolve_device
from ..ops import boundary, decode as dec_ops, place_kernel
from ..ops import replay_kernel as rk

CORPUS_DIR = (Path(__file__).resolve().parents[2] / "tests" / "resources"
              / "local_corpus")


def parser(doc: str, runs: int = 5) -> argparse.ArgumentParser:
    """An experiment's argument parser with --runs and --device."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--runs", type=int, default=runs,
                    help="timed calls a measurement; 0 checks parity only")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, with --runs 0")
    return ap


def device_of(args, device) -> torch.device:
    """The run's device (the caller's ``device`` over --device), refusing
    timing off the card."""
    dev = resolve_device(device if device is not None else args.device)
    check_timing(dev, args.runs)
    return dev


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def real_corpus(corpus_dir: Path = CORPUS_DIR):
    """The committed real corpus read from its files, as tools.bench reads
    a corpus: [(name, blob, desc, raw)], raw the oracle's pixels."""
    out = []
    for p in sorted(Path(corpus_dir).glob("*.qoi")):
        blob = np.fromfile(p, np.uint8)
        d = read_header(blob).value()
        out.append((p.stem, blob, d, oracle.decode(blob, d, d.channels)))
    expect(bool(out), f"no .qoi files in {corpus_dir}")
    return out


def measure(fn, runs: int) -> dict:
    """Event ms (mean of ``runs`` after 3 warmups), device busy ms and
    device operations a call (torch.profiler) of fn; {} without runs."""
    if not runs:
        return {}
    from ..utils.profile import profile_path

    ms = timed_ms(fn, runs=runs)
    prof = profile_path(fn, calls=2, warmup=1)
    return dict(ms=ms, device_ms=prof["busy_ms"],
                launches=sum(n for _, n in prof["groups"].values()))


def _fmt(r: dict) -> str:
    if not r:
        return "not timed"
    return (f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
            f"{r['launches']:g} launches)")


def time_stages(label: str, stages: dict, fused: tuple, runs: int,
                mpix: float, off_path=()) -> dict:
    """Time each stage (name -> zero-argument call on the previous stage's
    outputs) and the fused call (name, call); print one line a stage, the
    stage sum beside the fused call.  Returns {stage: measure()}, with
    "sum" (of the stages not in ``off_path``) and the fused call's."""
    out = {k: measure(fn, runs) for k, fn in stages.items()}
    out[fused[0]] = measure(fused[1], runs)
    for k in stages:
        print(f"[{label}] {k:>10}: {_fmt(out[k])}"
              + (" (not on the port's path)" if k in off_path else ""))
    if runs:
        on = [out[k] for k in stages if k not in off_path]
        out["sum"] = {key: sum(r[key] for r in on)
                      for key in ("ms", "device_ms", "launches")}
        f = out[fused[0]]
        print(f"[{label}] stage sum {_fmt(out['sum'])} | {fused[0]} "
              f"{_fmt(f)}, {mpix / f['ms'] * 1e3:.1f} MPix/s")
    return out


def decode_stages(regions, chunks_sizes, n_px: int, qb: int, n_cap: int,
                  resets=None):
    """The batch decode's stages after the regions (boundary, fields,
    replay, place), each a call on the materialized outputs of the one
    before, as BatchPipeline.decode_packed and packed._decode_lanes run
    them.  resets: None, or a call that makes the (B, qb) int32
    stream-start flags of packed lanes (in the fields stage, as
    packed.lane_inputs makes them).  Returns (stages, info, the place
    stage's output)."""
    def boundary_of():
        return boundary.analyze_region_batch(
            regions[:, :qb].contiguous(), chunks_sizes, n_px)

    info = boundary_of()

    def fields_of():
        meta, val = dec_ops.fields_dense_batch(regions, info["real"])
        if resets is not None:
            meta = meta | (resets() << 9)
        return meta.T, val.T  # lane-major, as K1 takes them

    meta_t, val_t = fields_of()
    emits = rk.replay_batch(meta_t, val_t).T.contiguous()
    stages = dict(
        boundary=boundary_of, fields=fields_of,
        replay=lambda: rk.replay_batch(meta_t, val_t),
        place=lambda: place_kernel.place_fill(info["pix_before"], emits,
                                              n_cap))
    return stages, info, stages["place"]()
