"""K3: stable compaction of kept rows (CUDA kernel csrc/compact.cu).

  out[p][b, g] = plane[p][b, r]   for every kept row r,
  g = the number of kept rows before r in lane b (the kernel counts them
      itself, one pass over keep; the plain version by torch.cumsum, as
      the JAX package computes it around its kernel)

Rows at or past counts[b] are unspecified; mask them downstream.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..utils import tracing

# The JAX kernel's rows per grid step.  The encoder's chunk_cap and `ok`
# rule are written in it, so it stays to keep those shapes and flags equal.
BLK = 2048
MAX_PLANES = 4


@functools.cache
def launch_shape() -> tuple[int, int]:
    """(rows a block, threads a block) of csrc/compact.cu, read from the
    built library, which owns them; builds the kernels on first use."""
    lib = kernels.library()
    return lib.qk_compact_tile(), lib.qk_compact_threads()


def _gidx_counts(keep):
    incl = torch.cumsum(keep, dim=1, dtype=torch.int32)
    return incl - keep.to(torch.int32), incl[:, -1]


def compact_rows_reference(planes, keep, cap: int):
    """Plain version of K3: cumsum + scatter_."""
    b, _ = keep.shape
    gidx, counts = _gidx_counts(keep)
    idx = torch.where(keep & (gidx < cap), gidx, cap).to(torch.int64)
    outs = []
    for p in planes:
        out = torch.zeros((b, cap + 1), dtype=p.dtype, device=p.device)
        out.scatter_(1, idx, p)  # dropped rows all land in column cap
        outs.append(out[:, :cap])
    return tuple(outs), counts


@tracing.traced("encode.compact")
def compact_rows(planes, keep, cap: int):
    """Compact the kept rows of up to four (B, N) int32 planes to the front.

    planes: tuple of (B, N) int32; keep: (B, N) bool; cap: output width (a
    lane whose count exceeds cap keeps its first cap rows).
    Returns (tuple of (B, cap) int32, counts (B,) int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if keep.device.type == "cpu":
        return compact_rows_reference(planes, keep, cap)
    b, n = keep.shape
    dev = keep.device
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1..{MAX_PLANES} planes, got {len(planes)}")
    kernels.check(keep, "keep", torch.bool, (b, n), dev)
    for i, p in enumerate(planes):
        kernels.check(p, f"planes[{i}]", torch.int32, (b, n), dev)
    if n >= 1 << 31:
        raise ValueError(f"{n} rows a lane do not fit int32 counts")
    outs = tuple(torch.empty((b, cap), dtype=torch.int32, device=dev)
                 for _ in planes)
    if not (b and n):
        return outs, torch.zeros((b,), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    # one look-back word per tile, then the ticket counter
    nstatus = b * -(-n // launch_shape()[0]) + 1
    status = torch.zeros(nstatus, dtype=torch.int64, device=dev)
    pad = [0] * (MAX_PLANES - len(planes))
    kernels.launch(
        "compact", "qk_compact", dev, keep.data_ptr(), status.data_ptr(),
        nstatus, len(planes), *[p.data_ptr() for p in planes], *pad,
        *[o.data_ptr() for o in outs], *pad, counts.data_ptr(), b, n, cap)
    return outs, counts
