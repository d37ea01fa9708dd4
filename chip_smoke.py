#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qoipp_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repository

0. prints the card (nvidia-smi name and power limit), torch and CUDA;
1. builds the four CUDA kernels from qoipp_tpu_torch/csrc;
2. checks each kernel against its plain PyTorch version on edge cases,
   bit-exact (tolerance 0);
3. drives BatchPipeline's main path at 1920x1088 — 16 RGB and 8 RGBA
   synthetic images (bench.make_corpus): decode_packed must equal the
   oracle's pixels, encode_packed_chunked and encode the oracle's streams;
4. requires every kernel's launch count from that run to be > 0;
5. checks each kernel against its plain version again at the main path's
   shapes and times both, then times decode and encode (1 cold, 3 warmup,
   5 timed runs, CUDA events).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure raises, so the script exits
non-zero with no final line; so does a machine without a CUDA device.
It never imports JAX.
"""

import sys

sys.modules["jax"] = None  # the port runs where JAX is absent

import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import make_corpus  # noqa: E402
from qoipp_tpu import oracle  # noqa: E402
from qoipp_tpu_torch import kernels  # noqa: E402
from qoipp_tpu_torch.kernels import selfcheck  # noqa: E402
from qoipp_tpu_torch.models.pipeline import BatchPipeline  # noqa: E402
from qoipp_tpu_torch.ops import (  # noqa: E402
    compact_kernel,
    emit_kernel,
    encode as enc_ops,
    place_kernel,
    replay_kernel,
)
from qoipp_tpu_torch.ops.bitops import pixels_to_packed  # noqa: E402

W, H = 1920, 1088
CORPORA = (("rgb", 16, 0, 3), ("rgba", 8, 7, 4))  # label, B, seed, channels
PLAIN_REPLAY_ROWS = 4096  # the plain replay loop runs ~1 ms per row
KERNELS = {  # name -> (source, the TPU kernel's function it replaces)
    "replay": ("qoipp_tpu_torch/csrc/replay.cu",
               "qoipp_tpu/ops/replay_kernel.py:183"),
    "place_fill": ("qoipp_tpu_torch/csrc/place_fill.cu",
                   "qoipp_tpu/ops/place_kernel.py:212"),
    "compact": ("qoipp_tpu_torch/csrc/compact.cu",
                "qoipp_tpu/ops/compact_kernel.py:212"),
    "emit": ("qoipp_tpu_torch/csrc/emit.cu",
             "qoipp_tpu/ops/emit_kernel.py:225"),
}


def log(*a):
    print(*a, flush=True)


def timed_ms(fn, warmup=3, runs=5):
    """Mean ms of fn over `runs` after `warmup`, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def expect(cond, what):
    if not cond:
        raise AssertionError(what)


def phase0_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    return card.splitlines()[0]


def phase1_build():
    t0 = time.perf_counter()
    report = kernels.build(verbose=True)
    kernels.library()
    log(f"phase 1: built {kernels.LIB_PATH.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())


def phase2_edge_cases(dev):
    for name in KERNELS:
        err = selfcheck.check(name, dev)
        log(f"phase 2: {name} vs plain on edge cases: max_abs_err {err}")
        expect(err == 0, f"{name} disagrees with its plain version")


def _oracle_packed(desc, blobs, dev):
    px = np.stack([oracle.decode(b, desc, desc.channels) for b in blobs])
    return pixels_to_packed(torch.from_numpy(px).to(dev), int(desc.channels))


def _expected_streams(blobs, out_cap, dev):
    want = np.zeros((len(blobs), out_cap), np.uint8)
    for i, b in enumerate(blobs):
        want[i, : b.size] = b
    return (torch.from_numpy(want).to(dev),
            torch.tensor([b.size for b in blobs], dtype=torch.int32,
                         device=dev))


def phase3_prepare(dev):
    runs = []
    for label, b, seed, ch in CORPORA:
        t0 = time.perf_counter()
        desc, raws, blobs = make_corpus(b, W, H, seed=seed, channels=ch)
        max_len = max(x.size for x in blobs)
        pipe = BatchPipeline(desc, max_stream_len=max_len,
                             max_encode_len=max_len + 4096, device=dev)
        streams, sizes = pipe.pack_streams(blobs)
        raws = np.stack(raws)
        packed_in = torch.nn.functional.pad(
            pixels_to_packed(torch.from_numpy(raws).to(dev), ch),
            (0, pipe.nb - pipe.n_px))
        runs.append(dict(
            label=label, desc=desc, pipe=pipe, blobs=blobs, raws=raws,
            streams=torch.from_numpy(streams).to(dev),
            sizes=torch.from_numpy(sizes).to(dev), packed_in=packed_in,
            want_px=_oracle_packed(desc, blobs, dev),
            want=_expected_streams(blobs, pipe.out_cap, dev)))
        log(f"phase 3: corpus {label}: {b} x {W}x{H}, streams "
            f"{min(x.size for x in blobs)}..{max_len} bytes, qb={pipe.qb}, "
            f"chunk_cap={pipe.chunk_cap}, out_cap={pipe.out_cap} "
            f"(made in {time.perf_counter() - t0:.1f} s)")
    return runs


def _check_streams(run, out, lengths, ok, what):
    want, want_len = run["want"]
    col = torch.arange(out.shape[1], device=out.device)[None, :]
    same = torch.where(col < want_len[:, None], out == want, True).all(dim=1)
    good = same & (lengths == want_len) & ok
    expect(bool(good.all()), f"{what}[{run['label']}]: images "
           f"{torch.nonzero(~good).flatten().tolist()} differ from the oracle")


def phase3_main_path(runs):
    for run in runs:
        pipe = run["pipe"]
        packed = pipe.decode_packed(run["streams"], run["sizes"])
        same = (packed[:, : pipe.n_px] == run["want_px"]).all(dim=1)
        expect(bool(same.all()), f"decode[{run['label']}]: images "
               f"{torch.nonzero(~same).flatten().tolist()} differ")
        _check_streams(run, *pipe.encode_packed_chunked(run["packed_in"],
                                                        sub=8),
                       "encode_packed_chunked")
        out, lengths = pipe.encode(run["raws"])
        _check_streams(run, out, lengths, torch.ones_like(lengths, dtype=bool),
                       "encode")
        log(f"phase 3: {run['label']}: decode_packed, encode_packed_chunked "
            f"and encode equal the oracle on all {len(run['blobs'])} images")


def _kernel_row(name, launches, err, ms, plain_ms, **extra):
    source, replaces = KERNELS[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **extra)


def phase5_kernels_at_main_shapes(run, launches):
    """Each kernel against its plain version on the inputs the main path
    gives it (RGB corpus), and both timed."""
    pipe = run["pipe"]
    rows = []
    meta_t, val_t, pix_before = pipe.replay_inputs(run["streams"],
                                                   run["sizes"])
    c, b = meta_t.shape
    prev0, seen0 = replay_kernel.initial_state(b, meta_t.device)
    # the plain replay is a Python loop: hold it to a prefix of the rows
    pm, pv = meta_t[:PLAIN_REPLAY_ROWS], val_t[:PLAIN_REPLAY_ROWS]
    err = max(selfcheck.max_abs_err(g, w) for g, w in zip(
        replay_kernel.replay_batch_carry(pm, pv, prev0, seen0),
        replay_kernel.replay_batch_carry_reference(pm, pv, prev0, seen0)))
    expect(err == 0, "replay disagrees with its plain version")
    ms = timed_ms(lambda: replay_kernel.replay_batch(meta_t, val_t))
    prefix_ms = timed_ms(lambda: replay_kernel.replay_batch(pm, pv))
    plain_ms = timed_ms(lambda: replay_kernel.replay_batch_carry_reference(
        pm, pv, prev0, seen0), warmup=1, runs=1)
    log(f"phase 5: replay (C={c}, B={b}): {ms:.3f} ms, "
        f"{ms / c * 1e6:.1f} ns/row; plain on {pm.shape[0]} rows "
        f"{plain_ms:.1f} ms = {plain_ms / pm.shape[0] * 1e3:.1f} us/row "
        f"(kernel on those rows {prefix_ms:.3f} ms)")
    rows.append(_kernel_row("replay", launches["replay"], err, ms, plain_ms,
                            rows=c, lanes=b, plain_rows=pm.shape[0],
                            ms_on_plain_rows=prefix_ms))

    emits = replay_kernel.replay_batch(meta_t, val_t).T.contiguous()
    args = (pix_before, emits, pipe.n_cap)
    err = selfcheck.max_abs_err(place_kernel.place_fill(*args),
                                place_kernel.place_fill_reference(*args))
    expect(err == 0, "place_fill disagrees with its plain version")
    ms = timed_ms(lambda: place_kernel.place_fill(*args))
    plain_ms = timed_ms(lambda: place_kernel.place_fill_reference(*args))
    log(f"phase 5: place_fill ({b} x {pix_before.shape[1]} rows -> "
        f"{pipe.n_cap} px): {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows.append(_kernel_row("place_fill", launches["place_fill"], err, ms,
                            plain_ms))

    packed = run["packed_in"][:8]  # the sub-batch encode_packed_chunked runs
    posflag, keep, fb = enc_ops.chunk_positions(packed, pipe.n_px)
    args = ((packed, posflag), keep, pipe.chunk_cap)
    (pk_c, pf_c), counts = compact_kernel.compact_rows(*args)
    (rk_c, rf_c), rcounts = compact_kernel.compact_rows_reference(*args)
    live = torch.arange(pipe.chunk_cap, device=counts.device)[None, :] < \
        counts[:, None]
    err = max(selfcheck.max_abs_err(counts, rcounts),
              *(selfcheck.max_abs_err(torch.where(live, g, 0),
                                      torch.where(live, w, 0))
                for g, w in ((pk_c, rk_c), (pf_c, rf_c))))
    expect(err == 0, "compact disagrees with its plain version")
    ms = timed_ms(lambda: compact_kernel.compact_rows(*args))
    plain_ms = timed_ms(lambda: compact_kernel.compact_rows_reference(*args))
    log(f"phase 5: compact (8 x {packed.shape[1]} rows, 2 planes -> "
        f"{pipe.chunk_cap}): {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows.append(_kernel_row("compact", launches["compact"], err, ms,
                            plain_ms))

    off, tlo, thn, _ = enc_ops.chunk_templates(pk_c, pf_c, counts, pipe.n_px,
                                               fb, pipe.channels)
    args = (off, tlo, thn, pipe.out_cap)
    err = selfcheck.max_abs_err(emit_kernel.emit_bytes(*args),
                                emit_kernel.emit_bytes_reference(*args))
    expect(err == 0, "emit disagrees with its plain version")
    ms = timed_ms(lambda: emit_kernel.emit_bytes(*args))
    plain_ms = timed_ms(lambda: emit_kernel.emit_bytes_reference(*args))
    log(f"phase 5: emit (8 x {off.shape[1]} rows -> {pipe.out_cap} bytes): "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows.append(_kernel_row("emit", launches["emit"], err, ms, plain_ms))
    return rows


def phase5_pipeline_times(run, card):
    pipe, b = run["pipe"], len(run["blobs"])
    mpix = b * pipe.n_px / 1e6
    for what, fn in (
        ("decode_packed", lambda: pipe.decode_packed(run["streams"],
                                                     run["sizes"])),
        ("encode_packed_chunked", lambda: pipe.encode_packed_chunked(
            run["packed_in"], sub=8)),
    ):
        cold = timed_ms(fn, warmup=0, runs=1)
        ms = timed_ms(fn, warmup=3, runs=5)
        log(f"phase 5: {what}[{run['label']}] B={b}: {ms:.2f} ms/batch = "
            f"{mpix / ms * 1e3:.1f} MPix/s (cold {cold:.2f} ms) on {card}")


def main():
    card = phase0_device()
    dev = torch.device("cuda")
    phase1_build()
    phase2_edge_cases(dev)
    runs = phase3_prepare(dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    phase3_main_path(runs)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"phase 4: launches on the main path: {launches}")
    for name in KERNELS:
        expect(launches[name] > 0, f"the main path never launched {name}")
    rows = phase5_kernels_at_main_shapes(runs[0], launches)
    for run in runs:
        phase5_pipeline_times(run, card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
