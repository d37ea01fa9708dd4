"""E7: byte emission over wide candidate slabs (csrc/emit_window.cu).

The TPU layout experiment ``benchmarks/expt_emit_wide.py`` asked whether
visiting two or four 128-row slabs at once cut the emit kernel's per-visit
cost.  It computes K4's function (ops/emit_kernel.py): row r writes
min(off[r+1] - off[r], 6) bytes of its template at off[r] (off[C] :=
out_cap + WIN), bytes at or past out_cap are dropped, every other byte is 0;
the output holds one int32 per byte.  The TPU kernel visited at most
``lenr`` candidate slabs per window and so drops the covering row of a run
of equal offs longer than that; the port's kernel visits every slab
``base_step`` names and writes it.

CPU tensors take the plain version; CUDA tensors launch the kernel (one
block per 8,192-byte window over the ``lanes``-row slabs that base_step
names; it reads only the rows before the slabs' trailing run of equal offs,
which a warp finds by a ballot search, and the run's last row) and raise
on any failure.  ``hoist`` shaped the TPU kernel's vector code only
and launches the same kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .emit_kernel import WIN, emit_bytes_reference
from .place_window import WIDE_LANES, _require
from .place_window import window_base_rows_w as _base_rows

def launch_shape(lanes: int = 256) -> tuple[int, int]:
    """(threads a block, resident blocks an SM) of the kernel at lanes,
    read from the built library; builds the kernels on first use."""
    threads = ctypes.c_int()
    n = kernels.library().qk_emit_window_occupancy(lanes,
                                                   ctypes.byref(threads))
    if n <= 0:
        raise RuntimeError(f"emit_window: occupancy query failed: CUDA "
                           f"error {-n}")
    return threads.value, n


def window_base_rows_w(off, out_cap: int, lanes: int):
    """(B, out_cap // WIN + 1) int32: per window edge w * WIN, the number
    of ``lanes``-row slabs whose last off is below it (C padded to
    ``lanes`` with off = out_cap + WIN): window w's candidate rows are slabs
    base[w] to base[w + 1], both included."""
    return _base_rows(off, out_cap, lanes, pad=out_cap + WIN)


def emit_wide_reference(off, tlo, thn, out_cap: int):
    """Plain version of E7: K4's plain version, one int32 per byte."""
    return emit_bytes_reference(off, tlo, thn, out_cap).to(torch.int32)


def emit_wide(off, tlo, thn, base_step, out_cap: int, lanes: int = 256,
              hoist: bool = True):
    """Materialise the encoded bytes from compacted chunk rows.

    off (B, C) int32 nondecreasing (strictly increasing on rows that
    emit); tlo, thn (B, C) int32 templates (thn bits 16+ ignored);
    base_step from window_base_rows_w(off, out_cap, lanes); out_cap % WIN
    == 0.  Returns (B, out_cap) int32, one byte per word."""
    b, c = off.shape
    _require(out_cap % WIN == 0, f"out_cap {out_cap} is not a multiple of "
             f"{WIN}")
    _require(tuple(base_step.shape) == (b, out_cap // WIN + 1),
             f"base_step shape {tuple(base_step.shape)}")
    _require(lanes in WIDE_LANES,
             f"lanes must be one of {WIDE_LANES}, got {lanes}")
    if off.device.type == "cpu":
        return emit_wide_reference(off, tlo, thn, out_cap)
    dev = off.device
    _require(out_cap + WIN < 1 << 31, f"out_cap {out_cap} does not fit "
             "int32 offsets")
    for name, t in (("off", off), ("tlo", tlo), ("thn", thn)):
        kernels.check(t, name, torch.int32, (b, c), dev)
    kernels.check(base_step, "base_step", torch.int32,
                  (b, out_cap // WIN + 1), dev)
    out = torch.empty((b, out_cap), dtype=torch.int32, device=dev)
    if b and out_cap:
        kernels.launch("emit_window", "qk_emit_window", dev, off.data_ptr(),
                       tlo.data_ptr(), thn.data_ptr(), base_step.data_ptr(),
                       out.data_ptr(), b, c, out_cap, lanes)
    return out
