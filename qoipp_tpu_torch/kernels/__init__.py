"""Builder, loader, launch counters and ctypes bindings of the CUDA kernels.

The port's fifteen kernels live in ``qoipp_tpu_torch/csrc`` as CUDA C++ for
sm_90a behind a plain C interface.  On first use they are built with
``nvcc`` (one compiler process per source, all at once, then one link)
into ``build/qoipp_tpu_torch/libqoipp_kernels.so`` at the root of the
checkout (rebuilt whenever a source is newer than the library) and loaded
with ctypes.  Nothing here runs when the module is
imported, so the CPU-only test suite can import it.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` after its launch; ``launch`` raises on a
non-zero status and only then counts the launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qoipp_tpu_torch"
LIB_PATH = BUILD_DIR / "libqoipp_kernels.so"
SOURCES = ("replay.cu", "place_fill.cu", "compact.cu", "emit.cu",
           "logfill.cu", "fields.cu", "place_window.cu", "place_fill2.cu",
           "place_grouped.cu", "place_narrow.cu", "place_variant.cu",
           "emit_window.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"replay": 0, "place_fill": 0, "compact": 0, "emit": 0,
            "replay_summary": 0, "logfill": 0, "fields": 0,
            "place_wide": 0, "place_fill2": 0, "place_fill_narrow": 0,
            "place_variant": 0, "place_grouped": 0, "emit_window": 0,
            "grid_step": 0, "onehot_place": 0, "dep_chain": 0}

_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_uint32)
_SIGNATURES = {
    # meta, val, prev_in, seen_in, emits, prev_out, seen_out, C, B, the
    # rows' row and lane strides, the emits', stream
    "qk_replay": [_P] * 7 + [_L, _I] + [_L] * 4 + [_P],
    # qk_replay's pointers, pupd, swr, C, B, strides, stream
    "qk_replay_summary": [_P] * 9 + [_L, _I] + [_L] * 4 + [_P],
    # pb, emits, out, status, B, Q, n_cap, stream
    "qk_place_fill": [_P] * 4 + [_I, _L, _L, _P],
    # keep, status, nstatus, nplanes, in0..in3, out0..out3, counts, B, N,
    # cap, stream
    "qk_compact": [_P, _P, _L, _I] + [_P] * 9 + [_I, _L, _L, _P],
    # rows a block, threads a block
    "qk_compact_tile": [],
    "qk_compact_threads": [],
    # off, tlo, thn, out, B, C, out_cap, stream
    "qk_emit": [_P] * 4 + [_I, _L, _L, _P],
    # words, out, B, n, stream
    "qk_logfill": [_P, _P, _I, _L, _P],
    # packed, n_px, prev_in, run_in, seen_in, tlo, thn, run_out, seen_out,
    # summary, B, Nb, channels, seg_tiles, stream
    "qk_fields": [_P] * 10 + [_I, _L, _I, _I, _P],
    # pb, emits, base, out, status, B, Q, n_cap, (lanes | ns), stream
    "qk_place_wide": [_P] * 5 + [_I, _L, _L, _I, _P],
    "qk_place_narrow": [_P] * 5 + [_I, _L, _L, _I, _P],
    "qk_place_fill2": [_P] * 5 + [_I, _L, _L, _P],
    # ..., n_cap, do_dma, do_slabs, n_fill, stream
    "qk_place_variant": [_P] * 5 + [_I, _L, _L, _I, _I, _I, _P],
    # ..., n_cap, nbase, win, g, lr_mode, static_in, stream
    "qk_place_grouped": [_P] * 5 + [_I, _L, _L] + [_I] * 5 + [_P],
    # resident blocks an SM, threads a block out: E3, E5, E6 (full); E4 at
    # win, g
    "qk_place_fill2_occupancy": [_P],
    "qk_place_narrow_occupancy": [_P],
    "qk_place_variant_occupancy": [_P],
    "qk_place_grouped_occupancy": [_I, _I, _P],
    # off, tlo, thn, base, out, B, C, out_cap, lanes, stream
    "qk_emit_window": [_P] * 5 + [_I, _L, _L, _I, _P],
    # x, y, steps, stream
    "qk_grid_step": [_P, _P, _L, _P],
    # t, v, out, nblk, K, nbins, stream
    "qk_onehot_place": [_P] * 3 + [_I, _L, _I, _P],
    # out, x, a, b, rounds, stream
    "qk_dep_chain": [_P, _U, _U, _U, _L, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir()
               if p.suffix in (".cu", ".cuh"))


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale: one nvcc
    per source, started together, then one link.  Returns the compilers'
    output (with ``verbose``, ptxas' register and spill report); raises
    RuntimeError if nvcc fails."""
    if not _stale() and not verbose:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [BUILD_DIR / f".{Path(s).stem}.{tag}.o" for s in SOURCES]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(CSRC / s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)]
    report = ""
    failed = []
    for s, p in zip(SOURCES, procs):
        out = p.communicate()[0]
        report += out
        if p.returncode != 0:
            failed.append(f"{s} ({p.returncode}):\n{out}")
    tmp = BUILD_DIR / f".libqoipp_kernels.{tag}.so"
    if not failed:
        proc = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        report += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, LIB_PATH)  # atomic: no process loads half a library
    return report


def sass(*names: str) -> str:
    """The SASS (``cuobjdump -sass`` of the built library) of the kernels
    whose entry names hold one of ``names``; builds the kernels first."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    library()
    text = subprocess.run([tool, "-sass", str(LIB_PATH)], check=True,
                          capture_output=True, text=True).stdout
    out, keep = [], False
    for line in text.splitlines():
        if "Function :" in line:
            keep = any(n in line for n in names)
        if keep:
            out.append(line)
    return "\n".join(out) + "\n"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.qk_error_string.argtypes = [ctypes.c_int]
            lib.qk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Launch C entry point ``entry`` on ``device``'s current stream (args
    exclude the stream), raise on a launch error, then count one launch of
    ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} "
                           f"({lib.qk_error_string(rc).decode()})")
    LAUNCHES[kernel] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device, contiguous: bool = True) -> None:
    """Raise ValueError unless t is a ``dtype`` tensor of ``shape`` on
    ``device``, and contiguous unless the kernel takes its strides."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
