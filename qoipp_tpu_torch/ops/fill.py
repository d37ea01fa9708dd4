"""Fill-forward: the last participating value at or before each position.

The counterpart of ``qoipp_tpu.ops.fill.fill_forward``.  The JAX package
packs (position, payload piece) into words and takes several cummaxes, a
workaround for the TPU's compile times and serial gathers; here the plain
form is one ``cummax`` of the index of the last participating position
and one gather per payload.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def fill_forward(payloads: Sequence[Tuple[torch.Tensor, int]], participate,
                 valid, axis: int = -1):
    """Inclusive fill-forward along ``axis``.

    payloads: [(int32 tensor, bit_width), ...], defined at participating
        positions; each is filled as its low ``bit_width`` bits.
    participate: bool tensor, the positions that enter the chain.
    valid: bool tensor, participating positions with a usable value; a
        participating invalid position blocks the chain.

    Returns (values, got, ok): the filled payloads (0 where not got); got,
    a participating position exists at or before q; ok, that latest
    participating position was valid."""
    n = participate.shape[axis]
    shape = [1] * participate.dim()
    shape[axis] = n
    pos = torch.arange(n, device=participate.device).reshape(shape)
    last = torch.cummax(torch.where(participate, pos, -1), dim=axis).values
    got = last >= 0
    src = last.clamp(min=0)
    ok = got & torch.gather(valid, axis, src)
    values = []
    for a, bits in payloads:
        v = torch.gather(a, axis, src)
        if bits < 32:
            v = v & ((1 << bits) - 1)
        values.append(torch.where(got, v, 0))
    return values, got, ok
