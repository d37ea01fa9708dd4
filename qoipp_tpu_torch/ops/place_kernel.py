"""K2: decode pixel placement + run fill (CUDA kernel csrc/place_fill.cu).

The windowed placement, which is the JAX K2's whole output: row r writes
emits[r] at pixel pb[r] iff pb[r+1] > pb[r] (n_cap after the last row) and
0 <= pb[r] < n_cap; inside each WIN-pixel window a pixel takes the word
of the nearest written pixel at or before it, at most 63 away (a chunk
produces at most 62 pixels), any other pixel the previous window's last
output (0 in an image's first window).  Up to each image's
last chunk that is the covering chunk's word; past it, the tail the JAX
package gives.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import tracing

WIN = 8192  # pixels per placement window


def writers(pb, n_cap: int):
    """(nxt, writes), both (B, Q): each row's next pb (n_cap after the
    last row) and whether the row writes (nxt > pb, 0 <= pb < n_cap)."""
    nxt = torch.cat([pb[:, 1:], torch.full_like(pb[:, :1], n_cap)], dim=1)
    return nxt, (nxt > pb) & (pb >= 0) & (pb < n_cap)


def place_fill_reference(pb, emits, n_cap: int, n_fill: int = 6,
                         place: bool = True):
    """Plain version of K2, the windowed placement of the module docstring.
    pb, emits (B, Q) int32 -> (B, n_cap) int32.  The windowed placement
    experiments (ops/place_window.py) compute it too; E6's ablations cut
    the fill's reach to 2**n_fill - 1 or, with place=False, place nothing
    (every pixel reads 0)."""
    if n_cap % WIN:
        raise ValueError(f"n_cap {n_cap} is not a multiple of {WIN}")
    b, q = pb.shape
    dev = pb.device
    pos = torch.full((b, n_cap), -1, dtype=torch.int32, device=dev)
    val = torch.zeros((b, n_cap), dtype=torch.int32, device=dev)
    if place and q:
        bi, ri = torch.nonzero(writers(pb, n_cap)[1], as_tuple=True)
        at = pb[bi, ri].long()
        pos[bi, at] = at.to(torch.int32)
        val[bi, at] = emits[bi, ri]
    return fill_units(pos, val, WIN, (1 << n_fill) - 1)


def fill_units(pos, val, unit: int, reach: int):
    """pos (B, n) int32: a pixel's own index where it is placed, else -1;
    val its word.  Each pixel takes the word of the nearest placed pixel at
    or to its left in its unit of ``unit`` pixels, at most ``reach`` away;
    any other pixel the carry, the previous unit's last output (0 in the
    first unit of each image).  Returns (B, n) int32."""
    b, n = pos.shape
    dev = pos.device
    nunit = n // unit
    near = torch.cummax(pos.view(b, nunit, unit), dim=2).values.view(b, n)
    px = torch.arange(n, dtype=torch.int32, device=dev)
    owned = (near >= 0) & (px - near <= reach)
    local = torch.gather(val, 1, near.clamp(min=0).long())
    # the carry into unit u: the last output of the nearest earlier unit
    # whose last pixel is its own, else 0
    last_owned = owned[:, unit - 1 :: unit]
    last_val = local[:, unit - 1 :: unit]
    u = torch.arange(nunit, dtype=torch.int32, device=dev)
    owner = torch.cummax(torch.where(last_owned, u, -1), dim=1).values
    src = torch.cat([torch.full((b, 1), -1, dtype=torch.int32, device=dev),
                     owner[:, :-1]], dim=1)
    carry = torch.where(src >= 0, torch.gather(last_val, 1,
                                               src.clamp(min=0).long()), 0)
    return torch.where(owned, local, carry.repeat_interleave(unit, dim=1))


@tracing.traced("decode.place")
def place_fill(pb, emits, n_cap: int):
    """Place chunk emits at their pixel offsets and fill runs.

    pb:    (B, Q) int32 boundary-pass pix_before, nondecreasing; any Q.
    emits: (B, Q) int32 replay output.
    n_cap: a multiple of WIN.
    Returns (B, n_cap) int32 packed pixels.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if pb.device.type == "cpu":
        return place_fill_reference(pb, emits, n_cap)
    if n_cap % WIN:
        raise ValueError(f"n_cap {n_cap} is not a multiple of {WIN}")
    b, q = pb.shape
    dev = pb.device
    kernels.check(pb, "pb", torch.int32, (b, q), dev)
    kernels.check(emits, "emits", torch.int32, (b, q), dev)
    if n_cap >= 1 << 31:
        raise ValueError(f"n_cap {n_cap} does not fit int32 offsets")
    out = torch.empty((b, n_cap), dtype=torch.int32, device=dev)
    if b and n_cap:
        # one look-back word per window, then the ticket counter
        status = torch.zeros(b * (n_cap // WIN) + 1, dtype=torch.int64,
                             device=dev)
        kernels.launch("place_fill", "qk_place_fill", dev, pb.data_ptr(),
                       emits.data_ptr(), out.data_ptr(), status.data_ptr(),
                       b, q, n_cap)
    return out
