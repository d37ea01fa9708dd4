"""Stream introspection: a decode-free chunk census of a QOI stream.

The port of ``qoipp_tpu.utils.debug``'s ``StreamStats`` and
``inspect_stream``, over the port's boundary pass.  The JAX package's
``strict_numerics`` and ``interpret_kernels`` switch JAX and Pallas modes
and have no counterpart: a kernel's plain version on CPU tensors plays
the interpreter's part.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..common import Desc, read_header
from ..convert import resolve_device
from ..ops import boundary


@dataclass
class StreamStats:
    """Per-op chunk census of a QOI stream."""

    desc: Desc
    chunks: int
    pixels: int
    ops: Dict[str, int]
    bytes_total: int

    def __str__(self) -> str:
        parts = ", ".join(f"{k}={v}" for k, v in self.ops.items())
        return (
            f"{self.desc.width}x{self.desc.height}x{int(self.desc.channels)}: "
            f"{self.chunks} chunks -> {self.pixels} px "
            f"({self.bytes_total} B; {parts})"
        )


def inspect_stream(data, device=None) -> StreamStats:
    """Chunk count, op histogram and pixel total of a QOI stream (bytes or
    a uint8 array), by the boundary pass on ``device`` (None: "cuda"):
    the observability hook that finds pathological streams before they
    reach a batch."""
    arr = np.asarray(
        np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray)
        else data
    ).reshape(-1)
    desc = read_header(arr).value()
    n_px = desc.width * desc.height
    qb = -(-(arr.size - 14) // boundary.BLOCK) * boundary.BLOCK
    region = np.zeros(qb + 8, np.uint8)
    region[: arr.size - 14] = arr[14:]
    info = boundary.analyze_region(
        torch.from_numpy(region[:qb]).to(resolve_device(device)),
        arr.size - 22, n_px)
    real = info["real"].cpu().numpy()
    tags = region[:qb][real]
    named_rgb = tags == 0xFE
    named_rgba = tags == 0xFF
    top = tags & 0xC0
    ops = {
        "RGB": int(named_rgb.sum()),
        "RGBA": int(named_rgba.sum()),
        "INDEX": int(((top == 0x00) & ~named_rgb & ~named_rgba).sum()),
        "DIFF": int(((top == 0x40) & ~named_rgb & ~named_rgba).sum()),
        "LUMA": int(((top == 0x80) & ~named_rgb & ~named_rgba).sum()),
        "RUN": int(((top == 0xC0) & ~named_rgb & ~named_rgba).sum()),
    }
    return StreamStats(
        desc=desc,
        chunks=int(info["total_chunks"]),
        pixels=int(info["total_pixels"]),
        ops=ops,
        bytes_total=int(arr.size),
    )
