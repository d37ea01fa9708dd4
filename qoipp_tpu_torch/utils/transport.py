"""Configurable granularity of the engines' large host-to-device uploads:
the port of ``qoipp_tpu.utils.transport``.

Every engine's big staging upload (the split, packed and stream decoders'
regions, the packed encoder's pixel and flag planes, the serving codec's
bucket batches) goes through ``stage_h2d``.  With a chunk size set, an
array of at least two chunks is cut along axis 0 into pieces of about
that size, and each piece is copied into its slice of one device tensor;
otherwise the upload is ``utils/transfer.upload`` as it is.  The bytes on
the device are the same either way: only the size of each transfer
changes.  ``benchmarks/expt_h2d_chunks.py`` measures the card's rates
against it.

Off by default.  Set it with ``set_h2d_chunk_bytes(n)`` or the
``QOIPP_TPU_H2D_CHUNK_BYTES`` environment variable, read when the module
is imported, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import tracing
from .transfer import upload

_chunk_bytes = int(os.environ.get("QOIPP_TPU_H2D_CHUNK_BYTES", "0") or 0)


def set_h2d_chunk_bytes(n: int) -> None:
    """Bytes a transfer of a staged upload; 0 turns chunking off (one
    copy an array, the default)."""
    global _chunk_bytes
    _chunk_bytes = int(n)


def get_h2d_chunk_bytes() -> int:
    return _chunk_bytes


def stage_h2d(arr, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, in axis-0 pieces of about
    the chunk size where chunking is set and the array holds at least two
    chunks and two rows (the JAX package's rule); otherwise ``upload``.

    On a card each piece goes through pinned memory into its slice of one
    preallocated tensor by a ``non_blocking`` copy on the current stream,
    so the result is ordered on that stream only; the caching host
    allocator keeps each pinned piece until its copy has run.  On the CPU
    the pieces are cut and copied into their slices all the same.  Either
    way the upload is one ``host.upload`` span."""
    a = np.asarray(arr)
    cb = _chunk_bytes
    if cb <= 0 or a.nbytes < 2 * cb or a.ndim == 0 or a.shape[0] < 2:
        return upload(a, device)
    rows = max(cb // max(a.nbytes // a.shape[0], 1), 1)
    with tracing.span("host.upload"):
        host = torch.from_numpy(np.ascontiguousarray(a))
        tracing.count("h2d_bytes", host.nbytes)
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
        card = device.type == "cuda"
        for i in range(0, a.shape[0], rows):
            piece = host[i: i + rows]
            out[i: i + rows].copy_(piece.pin_memory() if card else piece,
                                   non_blocking=card)
    return out
