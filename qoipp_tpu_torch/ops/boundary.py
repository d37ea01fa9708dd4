"""Parallel QOI chunk-boundary discovery.

The phase phi(p) = (next chunk start >= p) - p lies in {0..4} and steps as

    phi(p+1) = phi(p) - 1      if phi(p) > 0
             = len(p) - 1      if phi(p) == 0   (p starts a chunk)

so a span of bytes is a phase map {0..4} -> {0..4}, and the chunk starts
are a scan of composed maps.  ``chunk_starts_batch`` launches the CUDA
kernel csrc/boundary.cu on CUDA tensors (one pass, a decoupled look-back
across 4 KiB tiles; it replaces no Pallas kernel: the JAX package's scan is
plain JAX) and takes the plain version on CPU tensors.  The plain version,
``chunk_starts_batch_plain``, is the same three-stage scan as
``qoipp_tpu.ops.boundary``:

A: each BLOCK-byte block's phase map {0..4} -> {0..4}, by a BLOCK-step loop
   over a (B, 5, nblk) carry;
B: the exclusive composition of the block maps, by log-doubling with
   ``torch.gather`` (in place of ``associative_scan``);
C: a second BLOCK-step loop replays every block from its entry phase.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..utils import tracing

BLOCK = 128  # bytes per phase block


def chunk_len_of(tags):
    """Chunk byte length decided by the tag byte alone: INDEX/DIFF/RUN=1,
    LUMA=2, RGB=4, RGBA=5 (uint8)."""
    t = tags.to(torch.int32)
    is_rgb = t == 0xFE
    is_rgba = t == 0xFF
    is_luma = ~is_rgb & ~is_rgba & ((t & 0xC0) == 0x80)
    return (1 + is_luma.to(torch.int32) + 3 * is_rgb.to(torch.int32)
            + 4 * is_rgba.to(torch.int32)).to(torch.uint8)


@functools.cache
def scan_tile() -> int:
    """Bytes a block of csrc/boundary.cu, read from the built library,
    which owns it; builds the kernels on first use."""
    return kernels.library().qk_chunk_starts_tile()


def chunk_starts_batch(regions):
    """regions: (B, Qb) uint8 chunk-region bytes (stream bytes from offset
    14, zero-padded; Qb % BLOCK == 0), any row stride, unit column stride.
    Returns is_start: (B, Qb) bool.  Position 0 is by definition the first
    chunk start.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch and the zeroed status words, whatever the shape)."""
    if regions.device.type == "cpu":
        return chunk_starts_batch_plain(regions)
    b, qb = regions.shape
    dev = regions.device
    kernels.check(regions, "regions", torch.uint8, (b, qb), dev,
                  contiguous=False)
    if qb % BLOCK:
        raise ValueError(f"region width {qb} is not a multiple of {BLOCK}")
    if b and qb and regions.stride(1) != 1:
        raise ValueError(f"regions: column stride {regions.stride(1)}, "
                         "expected 1")
    out = torch.empty((b, qb), dtype=torch.bool, device=dev)
    if not (b and qb):
        return out
    # one look-back word per tile, then the ticket counter
    nstatus = b * -(-qb // scan_tile()) + 1
    status = torch.zeros(nstatus, dtype=torch.int64, device=dev)
    kernels.launch("chunk_starts", "qk_chunk_starts", dev, regions.data_ptr(),
                   regions.stride(0), out.data_ptr(), status.data_ptr(),
                   nstatus, b, qb)
    tracing.count("boundary_scans")
    tracing.count("boundary_scan_bytes", b * qb)
    return out


def chunk_starts_batch_plain(regions):
    """Plain version of chunk_starts_batch: the BLOCK-step loops above, any
    device."""
    b, qb = regions.shape
    if qb % BLOCK:
        raise ValueError(f"region width {qb} is not a multiple of {BLOCK}")
    nblk = qb // BLOCK
    lens = chunk_len_of(regions).reshape(b, nblk, BLOCK)
    steps = lens - 1  # phase after a chunk start

    # A: per-block phase maps, carry[b, j, k] = phase after block k from j
    ident = torch.arange(5, dtype=torch.uint8, device=regions.device)
    carry = ident[None, :, None].expand(b, 5, nblk).clone()
    for t in range(BLOCK):
        carry = torch.where(carry > 0, carry - 1, steps[:, None, :, t])

    # B: inclusive composition by log-doubling (apply block k-d's span,
    # then block k's: S_k[S_{k-d}[j]]), then shift to exclusive
    inc = carry.to(torch.int64)
    d = 1
    while d < nblk:
        inc = torch.cat(
            [inc[:, :, :d], torch.gather(inc[:, :, d:], 1, inc[:, :, :-d])],
            dim=2,
        )
        d *= 2
    entry = torch.cat(
        [torch.zeros((b, 1), dtype=torch.uint8, device=regions.device),
         inc[:, 0, :-1].to(torch.uint8)],
        dim=1,
    )  # the chain enters block 0 with phi = 0

    # C: replay every block from its entry phase
    phases = torch.empty((b, nblk, BLOCK), dtype=torch.uint8,
                         device=regions.device)
    phi = entry
    for t in range(BLOCK):
        phases[:, :, t] = phi
        phi = torch.where(phi > 0, phi - 1, steps[:, :, t])
    return phases.reshape(b, qb) == 0


def chunk_starts(region):
    """Single-stream chunk_starts_batch: (Qb,) uint8 -> (Qb,) bool."""
    return chunk_starts_batch(region[None])[0]


@tracing.traced("decode.boundary")
def analyze_region_batch(regions, chunks_sizes, n_px: int):
    """Batched boundary analysis.

    regions:      (B, Qb) uint8, stream bytes from offset 14, zero-extended.
    chunks_sizes: (B,) int, real chunk-region byte counts (stream size - 22;
                  the reference's loop bound).
    n_px:         pixels each image owes.

    Returns a dict of (B, Qb) arrays — real (a chunk the reference would
    decode: data left OR pixels owed), produced (pixels it emits), and
    pix_before (int32 exclusive prefix sum of produced) — plus the (B,)
    totals total_chunks and total_pixels.
    """
    b, qb = regions.shape
    q = torch.arange(qb, dtype=torch.int32, device=regions.device)[None, :]
    is_start = chunk_starts_batch(regions)

    tag = regions.to(torch.int32)
    # 0xFE/0xFF are RGB/RGBA, not RUN
    is_run = ((tag & 0xC0) == 0xC0) & (tag != 0xFE) & (tag != 0xFF)
    produced_raw = torch.where(is_run, (tag & 0x3F) + 1, 1)

    produced0 = torch.where(is_start, produced_raw, 0)
    pix_before0 = torch.cumsum(produced0, dim=1, dtype=torch.int32) - produced0

    sizes = torch.as_tensor(chunks_sizes, device=regions.device)
    real = is_start & ((q < sizes.to(torch.int32)[:, None])
                       | (pix_before0 < n_px))
    produced = torch.where(real, produced_raw, 0)
    pix_before = torch.cumsum(produced, dim=1, dtype=torch.int32) - produced

    return {
        "real": real,
        "produced": produced,
        "pix_before": pix_before,
        "total_chunks": real.sum(dim=1, dtype=torch.int32),
        "total_pixels": produced.sum(dim=1, dtype=torch.int32),
    }


def analyze_region(region, chunks_size: int, n_px: int):
    """Single-stream boundary analysis: analyze_region_batch at B=1, with
    (Qb,) results and scalar totals."""
    out = analyze_region_batch(
        region[None], torch.tensor([chunks_size], device=region.device), n_px)
    return {k: v[0] for k, v in out.items()}
