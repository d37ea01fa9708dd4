"""K4: encoder byte emission (CUDA kernel csrc/emit.cu).

Row r of the compacted chunk stream writes min(off[r+1] - off[r], 6) bytes
of its template (tlo bytes 0-3, thn bytes 4-5) at off[r]; the last row
takes off[C] = out_cap + WIN.  Every other byte reads 0.
"""

from __future__ import annotations

import torch

from .. import kernels

WIN = 8192  # out_cap granularity and the last row's pad, as in the JAX package


def emit_bytes_reference(off, tlo, thn, out_cap: int):
    """Plain version of K4: six masked scatter_s."""
    b = off.shape[0]
    off = off.to(torch.int64)
    nxt = torch.cat([off[:, 1:], torch.full_like(off[:, :1], out_cap + WIN)],
                    dim=1)
    n = nxt - off
    out = torch.zeros((b, out_cap + 1), dtype=torch.uint8, device=off.device)
    for k in range(6):
        word, shift = (tlo, 8 * k) if k < 4 else (thn, 8 * (k - 4))
        pos = off + k
        hit = (k < n) & (pos >= 0) & (pos < out_cap)
        byte = ((word >> shift) & 0xFF).to(torch.uint8)
        out.scatter_(1, torch.where(hit, pos, out_cap), byte)
    return out[:, :out_cap]


def emit_bytes(off, tlo, thn, out_cap: int):
    """Materialise the encoded byte stream from compacted chunk rows.

    off: (B, C) int32 byte offset of each row, nondecreasing (strictly
         increasing on rows that emit);
    tlo/thn: (B, C) int32 templates (thn bits 16+ are ignored here).
    Returns (B, out_cap) uint8.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if off.device.type == "cpu":
        return emit_bytes_reference(off, tlo, thn, out_cap)
    b, c = off.shape
    dev = off.device
    kernels.check(off, "off", torch.int32, (b, c), dev)
    kernels.check(tlo, "tlo", torch.int32, (b, c), dev)
    kernels.check(thn, "thn", torch.int32, (b, c), dev)
    out = torch.zeros((b, out_cap), dtype=torch.uint8, device=dev)
    if b and c:
        kernels.launch("emit", "qk_emit", dev, off.data_ptr(), tlo.data_ptr(),
                       thn.data_ptr(), out.data_ptr(), b, c, out_cap)
    return out
