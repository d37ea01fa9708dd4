"""G1, the pixel gather: decoded pixel words -> each stream's raw channel
bytes, back to back in one flat buffer.

The packed and split decoders leave (L, n_cap) int32 planes of pixel words
r | g<<8 | b<<16 | a<<24 on the device, each stream in one run of a lane
(packed) or one run a lane (split).  A segment is such a run: n words from
source word s, which land at output byte dst as their low ``channels``
bytes each (4 for RGBA, 3 for RGB).  ``gather_pixels`` writes every
segment of a table and no other byte: on CUDA tensors by the kernel
csrc/gather.cu (it replaces no Pallas kernel: the JAX package fetches the
whole planes and unpacks each stream on the host), on CPU tensors by the
plain version ``gather_pixels_plain``, a byte view of the words and a
slice copy a segment.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import tracing
from ..utils.transfer import upload

# pixels a block of the kernel: 1,024 groups of 4 words, counted from the
# segment's first word rounded down to a multiple of 4
TILE_PX = 4096


def segment_table(segments: Iterable[Tuple[int, int, int, int]]
                  ) -> np.ndarray:
    """(first source word, pixels, first output byte, channels) segments ->
    the (S, 5) int64 table gather_pixels takes: segments of no pixels
    dropped, each row's first tile (the tiles of the rows before it)
    appended."""
    rows = np.asarray([s for s in segments if s[1] > 0],
                      np.int64).reshape(-1, 4)
    tiles = -(-(rows[:, 0] % 4 + rows[:, 1]) // TILE_PX)
    return np.concatenate([rows, (np.cumsum(tiles) - tiles)[:, None]], axis=1)


def _check_table(table: np.ndarray, n_words: int, out_bytes: int) -> None:
    """Raise ValueError unless every row of a segment_table lies inside a
    source of n_words words and an output of out_bytes bytes."""
    if table.dtype != np.int64 or table.ndim != 2 or table.shape[1] != 5:
        raise ValueError(f"table: {table.dtype} {table.shape}, expected "
                         "int64 (S, 5)")
    s, n, dst, c = table[:, :4].T
    bad = ((c != 3) & (c != 4)) | (s < 0) | (n < 1) | (s + n > n_words) | (
        dst < 0) | (dst + n * c > out_bytes)
    if bad.any():
        raise ValueError(f"table row {int(np.argmax(bad))} lies outside the "
                         f"{n_words} source words or the {out_bytes} output "
                         "bytes, or has channels other than 3 and 4")


def gather_pixels(src: torch.Tensor, table: np.ndarray, out: torch.Tensor,
                  table_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write each segment of ``table`` (segment_table's, on the host) from
    ``src``, contiguous int32 pixel words of any shape, into ``out``, a
    (N,) uint8 tensor on src's device; no other byte of out changes.
    Returns out and counts the segments' pixels as ``gather_px``.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (none for an empty table) and read ``table_dev``, the table on the card
    (uploaded here where None)."""
    _check_table(table, src.numel(), out.numel())
    if src.device.type == "cpu":
        gather_pixels_plain(src, table, out)
    else:
        dev = src.device
        kernels.check(src, "src", torch.int32, tuple(src.shape), dev)
        kernels.check(out, "out", torch.uint8, (out.numel(),), dev)
        if src.data_ptr() % 16:
            raise ValueError("src: not 16-byte aligned")
        if table_dev is None:
            table_dev = upload(table, dev)
        kernels.check(table_dev, "table_dev", torch.int64, table.shape, dev)
        if len(table):
            s, n = table[-1, 0], table[-1, 1]
            ntiles = int(table[-1, 4] + -(-(s % 4 + n) // TILE_PX))
            kernels.launch("gather_pixels", "qk_gather_pixels", dev,
                           src.data_ptr(), src.numel(), table_dev.data_ptr(),
                           len(table), TILE_PX // 4, ntiles, out.data_ptr(),
                           out.numel())
    tracing.count("gather_px", int(table[:, 1].sum()))
    return out


def gather_pixels_plain(src: torch.Tensor, table: np.ndarray,
                        out: torch.Tensor) -> torch.Tensor:
    """Plain version of gather_pixels, any device: the words' byte view
    (little-endian: r, g, b, a) and one slice copy a segment."""
    px = src.reshape(-1).view(torch.uint8).view(-1, 4)
    for s, n, dst, c, _ in table.tolist():
        out[dst: dst + n * c] = px[s: s + n, :c].reshape(-1)
    return out
