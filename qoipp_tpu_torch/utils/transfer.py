"""Host-to-device uploads of the engines' staged plans, and the fetches and
flag reads that bring device results back to the host.

Every ``stage_plan`` moves its numpy plan to the device through ``upload``:
on a CUDA device by way of pinned host memory and a ``non_blocking`` copy,
so the host goes on planning while the copy runs and the copy overlaps
what the card is computing.  PyTorch's caching host allocator records the
copy's stream against the pinned block and hands the block out again only
after the copy has finished, so the pinned tensor may be dropped once the
copy is issued; an array that already views such a block (``pinned_owner``)
is copied from it as it is.  On the CPU the array is wrapped without a
copy.

``fetch``, ``fetch_pinned`` and ``read_flag`` wait for the device: each is
one ``host.fetch`` or ``host.sync`` span and one ``host_syncs`` count
(``utils/tracing``).  ``fetch`` copies into pageable memory;
``fetch_pinned`` copies a tensor into a pinned block of the same caching
host allocator, then once more into a fresh numpy array, so the block goes
back to the cache, and the next call of that size takes it again without
a new ``cudaHostAlloc``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import tracing


def pinned_owner(x) -> Optional[torch.Tensor]:
    """The pinned host tensor that ``x`` is, or whose whole storage the
    numpy array ``x`` views as ``Tensor.numpy()`` gives it
    (``BatchPipeline.pack_streams``' outputs on a card); None for anything
    else.  A copy issued from it records its stream on the tensor's block
    of the caching host allocator; one issued from ``torch.from_numpy(x)``
    may not, since that tensor does not own the block."""
    t = x
    if isinstance(x, np.ndarray):
        t = x.base
        if not (isinstance(t, torch.Tensor)
                and t.data_ptr() == x.ctypes.data):
            return None
        v = t.numpy()
        if (v.dtype, v.shape, v.strides) != (x.dtype, x.shape, x.strides):
            return None
    if not (isinstance(t, torch.Tensor) and t.device.type == "cpu"
            and t.is_pinned()):
        return None
    return t


@tracing.traced("host.upload")
def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, copied asynchronously from
    pinned memory where the device is a card: from the array's own block
    where it views one (``pinned_owner``), else from a pinned copy of it.
    Counts ``h2d_bytes``."""
    card = device.type == "cuda"
    t = pinned_owner(arr) if card else None
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if card:
            t = t.pin_memory()
    tracing.count("h2d_bytes", t.nbytes)
    return t.to(device, non_blocking=card)


def fetch(*tensors: torch.Tensor):
    """The tensors as host numpy arrays, in one ``host.fetch`` span; counts
    their bytes as ``d2h_bytes`` and one ``host_syncs``."""
    with tracing.span("host.fetch"):
        out = tuple(t.cpu().numpy() for t in tensors)
    tracing.count("d2h_bytes", sum(a.nbytes for a in out))
    tracing.count("host_syncs")
    return out


def fetch_pinned(t: torch.Tensor) -> np.ndarray:
    """A tensor as a fresh host numpy array: on a card one asynchronous
    copy into a pinned block and one wait, in one ``host.fetch`` span
    (counts its bytes as ``d2h_bytes`` and one ``host_syncs``), then one
    host copy out of the block into fresh memory, outside the span (torch's
    copy, on its threads: the fresh pages' first touch and the copy split
    between them).  The result aliases no memory that a later call
    reuses."""
    pinned = t.device.type == "cuda"
    host = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if pinned
            else t)
    with tracing.span("host.fetch"):
        if pinned:
            host.copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
    tracing.count("d2h_bytes", host.nbytes)
    tracing.count("host_syncs")
    return torch.empty(host.shape, dtype=host.dtype).copy_(host).numpy()


def read_flag(t: torch.Tensor) -> bool:
    """``bool(t)`` of a one-element device tensor, in one ``host.sync``
    span; counts one ``host_syncs``."""
    with tracing.span("host.sync"):
        v = bool(t)
    tracing.count("host_syncs")
    return v
