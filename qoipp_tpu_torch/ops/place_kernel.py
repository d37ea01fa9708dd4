"""K2: decode pixel placement + run fill (CUDA kernel csrc/place_fill.cu).

Row r of the byte-domain replay output starts a chunk iff pb[r+1] > pb[r]
and then covers pixels [pb[r], pb[r+1]) with emits[r].  Output-driven:
pixel p takes emits of the last row with pb <= p (the covering chunk
start); rows with pb >= n_cap write nothing; past the last chunk the last
row repeats the running value; pixels before pb[0] read 0.
"""

from __future__ import annotations

import torch

from .. import kernels

WIN = 8192  # n_cap granularity, kept so decode shapes match the JAX package


def place_fill_reference(pb, emits, n_cap: int):
    """Plain version of K2: searchsorted + gather."""
    b = pb.shape[0]
    p = torch.arange(n_cap, dtype=pb.dtype, device=pb.device)
    r = torch.searchsorted(pb, p.expand(b, n_cap).contiguous(), right=True) - 1
    out = torch.gather(emits, 1, r.clamp(min=0))
    return torch.where(r >= 0, out, 0)


def place_fill(pb, emits, n_cap: int):
    """Place chunk emits at their pixel offsets and fill runs.

    pb:    (B, Q) int32 boundary-pass pix_before, nondecreasing.
    emits: (B, Q) int32 replay output.
    Returns (B, n_cap) int32 packed pixels.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap)
    b, q = pb.shape
    dev = pb.device
    kernels.check(pb, "pb", torch.int32, (b, q), dev)
    kernels.check(emits, "emits", torch.int32, (b, q), dev)
    out = torch.empty((b, n_cap), dtype=torch.int32, device=dev)
    if b and n_cap:
        kernels.launch("place_fill", "qk_place_fill", dev, pb.data_ptr(),
                       emits.data_ptr(), out.data_ptr(), b, q, n_cap)
    return out
