"""Host-to-device uploads of the engines' staged plans, and the fetches and
flag reads that bring device results back to the host.

Every ``stage_plan`` moves its numpy plan to the device through ``upload``:
on a CUDA device by way of pinned host memory and a ``non_blocking`` copy,
so the host goes on planning while the copy runs and the copy overlaps
what the card is computing.  PyTorch's caching host allocator records the
copy's stream against the pinned block and hands the block out again only
after the copy has finished, so the pinned tensor may be dropped once the
copy is issued.  On the CPU the array is wrapped without a copy.

``fetch``, ``fetch_pinned`` and ``read_flag`` wait for the device: each is
one ``host.fetch`` or ``host.sync`` span and one ``host_syncs`` count
(``utils/tracing``).  ``fetch`` copies into pageable memory;
``fetch_pinned`` copies a tensor into a pinned block of the same caching
host allocator, then once more into a fresh numpy array, so the block goes
back to the cache, and the next call of that size takes it again without
a new ``cudaHostAlloc``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing


@tracing.traced("host.upload")
def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, copied asynchronously from
    pinned memory where the device is a card.  Counts ``h2d_bytes``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    tracing.count("h2d_bytes", t.nbytes)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
