"""Roofline shares of the program's kernels: the peaks of the card, and
the bytes and 32-bit operations each kernel's work needs, counted from the
cell's inputs (what the streams and images hold), never from the
program's padded shapes, so they read the same work whatever implements
it.

A share is the least time the card could take, the larger of bytes over
the peak bandwidth and operations over the peak 32-bit rate, divided by
the kernel's device time a call.  Peaks are NVIDIA's data sheet figures
(SXM part, 700 W); the run reports the card's power limit beside them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from .trace import port_kernel

# torch.cuda.get_device_name() -> (HBM bytes/s, 32-bit operations/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}

# 32-bit operations a row or pixel: the work's own arithmetic
REPLAY_OPS_PER_CHUNK = 24  # decode a chunk's op, hash, table and state
PLACE_OPS_PER_PIXEL = 14  # the nearest writer at or before, a select
COMPACT_OPS_PER_ROW = 3  # test, count, store index
EMIT_OPS_PER_BYTE = 4  # shift, mask, store, bound test
FIELDS_OPS_PER_PIXEL = 24  # hash, run and index tests, diffs, template


class Work(NamedTuple):
    bytes: float
    ops: float


def k1_replay(chunks: int, lanes: int) -> Work:
    """K1 on the streams' real chunk rows: meta and val read and the
    emit written (12 bytes a chunk); the 65-word state in and out a
    lane."""
    return Work(12 * chunks + 4 * 65 * 2 * lanes,
                REPLAY_OPS_PER_CHUNK * chunks)


def k2_place(chunks: int, pixels: int) -> Work:
    """K2: each chunk's pixel offset and emit read (8 bytes), each pixel
    placed written (4 bytes)."""
    return Work(8 * chunks + 4 * pixels, PLACE_OPS_PER_PIXEL * pixels)


def e1_fields(pixels: int) -> Work:
    """E1 (the encode fields pass): each pixel read (4 bytes, packed) and
    its two template words written (8 bytes)."""
    return Work(12 * pixels, FIELDS_OPS_PER_PIXEL * pixels)


def k3_compact(rows: int, kept: int, planes: int = 2) -> Work:
    """K3: the keep flag of every row scanned (1 byte), each kept row's
    planes read and written (4 bytes a plane each way)."""
    return Work(rows + 8 * planes * kept, COMPACT_OPS_PER_ROW * rows)


def k4_emit(rows: int, stream_bytes: int) -> Work:
    """K4: each row's offset and 6-byte template read (12 bytes: off,
    tlo, thn), each stream byte written."""
    return Work(12 * rows + stream_bytes, EMIT_OPS_PER_BYTE * stream_bytes)


def bound_s(work: Work, kind: str) -> Optional[float]:
    peaks = PEAKS.get(kind)
    if peaks is None:
        return None
    return max(work.bytes / peaks[0], work.ops / peaks[1])


def share(rec, work_key: str, *kernels: str, exclude: str = "") -> Optional[
        float]:
    """Percent of the roofline of the program's ``kernels`` (function names
    of trace.PORT_KERNELS: the launches that do the work together; names
    holding ``exclude`` left out) in the traced run: the bound of the work
    a call needs over their device time a traced call.  None where the run
    has no trace, no such kernel, no work counted or no peaks for its
    card."""
    tr = rec.trace
    work = rec.work.get(work_key)
    if tr is None or work is None:
        return None
    t = sum(e.end - e.start for e in tr.device
            if port_kernel(e.name) in kernels
            and not (exclude and exclude in e.name))
    b = bound_s(work, rec.device_kind)
    if not t or b is None:
        return None
    return 100.0 * b / (t / tr.calls)
