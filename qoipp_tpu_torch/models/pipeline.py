"""Batched device-resident codec pipeline — the port's main path.

``BatchPipeline`` decodes a batch of same-geometry QOI streams into packed
pixel planes, and encodes packed pixels or raw images back into streams,
with every stage on one device:

  decode: boundary pass -> dense chunk fields -> K1 replay -> K2 place+fill
  encode: chunk positions -> K3 compact -> templates -> K4 emit

Shapes are the JAX package's (``qoipp_tpu.models.pipeline``); outputs stay
on the pipeline's device.  Pixel words are int32 tensors holding the uint32
bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import oracle
from ..common import Channels, Desc, write_header
from ..ops import boundary
from ..ops import decode as dec_ops
from ..ops import encode as enc_ops
from ..ops import place_kernel
from ..ops import replay_kernel as rk
from ..ops.bitops import packed_to_pixels, pixels_to_packed
from ..ops.encode import _round_up
from ..utils import tracing
from ..utils.transfer import pinned_owner


class BatchPipeline:
    """Fixed-geometry batched QOI codec for a uniform image shape.

    Parameters
    ----------
    desc: image geometry (width/height/channels shared by the batch).
    max_stream_len: longest QOI stream (bytes) the decode path must accept;
        defaults to worst_size(desc).  Tighter bounds shorten the replay.
    max_encode_len: longest QOI stream the encode path may produce;
        defaults to worst_size(desc).  Images that overflow it are flagged
        by the *_checked entry points, and encode() raises on them.
    device: where inputs are moved and outputs stay; None means "cuda"
        (a CUDA device runs the kernels, "cpu" their plain versions).
    """

    def __init__(
        self,
        desc: Desc,
        max_stream_len: Optional[int] = None,
        max_encode_len: Optional[int] = None,
        device=None,
    ):
        self.desc = desc
        self.device = torch.device("cuda" if device is None else device)
        self.channels = int(desc.channels)
        self.n_px = desc.width * desc.height

        worst = (self.channels + 1) * self.n_px + 22
        max_stream_len = max_stream_len or worst
        self.max_encode_len = max_encode_len or worst
        self.qb = _round_up(max(max_stream_len - 14, boundary.BLOCK),
                            boundary.BLOCK)
        self.l_cap = 14 + self.qb + 8  # stream rows carry 8 bytes of slack
        self.n_cap = _round_up(self.n_px, place_kernel.WIN)

        self.nb = enc_ops.pad_to_tile(self.n_px)
        # chunk count is bounded both by emitting pixels and stream bytes
        self.chunk_cap, self.out_cap = enc_ops.encode_caps(
            self.nb, self.channels,
            chunk_cap=min(self.nb, self.max_encode_len) + 2048 + 256,
            out_cap=self.max_encode_len)
        self._header = torch.as_tensor(
            np.frombuffer(write_header(desc), dtype=np.uint8).copy(),
            device=self.device)

    def _to_device(self, x, dtype):
        if isinstance(x, torch.Tensor) and (x.device.type != "cpu"
                                            or self.device.type == "cpu"):
            return x.to(device=self.device, dtype=dtype)
        pinned = pinned_owner(x) if self.device.type == "cuda" else None
        t = torch.as_tensor(x) if pinned is None else pinned
        with tracing.span("host.upload"):
            tracing.count("h2d_bytes", t.nbytes)
            if pinned is not None:  # pack_streams' block: one async copy
                return t.to(device=self.device, dtype=dtype,
                            non_blocking=True)
            # a pageable host array: a plain copy
            tracing.count("h2d_pageable_bytes", t.nbytes)
            return t.to(device=self.device, dtype=dtype)

    # -- decode ------------------------------------------------------------

    def replay_inputs(self, streams, sizes):
        """The stages before the kernels: (B, l_cap) uint8 streams + (B,)
        sizes -> (meta, val) (qb, B) int32 rows for K1, lane-major (views
        of the (B, qb) planes), and the (B, qb) int32 pixel offsets for
        K2."""
        streams = self._to_device(streams, torch.uint8)
        sizes = self._to_device(sizes, torch.int32)
        regions = streams[:, 14:]
        q = torch.arange(regions.shape[1], dtype=torch.int32,
                         device=self.device)[None, :]
        # bytes past the stream are zero: INDEX-0 chunks that stay real
        # while pixels are owed (the reference's tolerant loop)
        regions = torch.where(q < (sizes - 14)[:, None], regions, 0)
        info = boundary.analyze_region_batch(
            regions[:, : self.qb].contiguous(), sizes - 22, self.n_px)
        meta, val = dec_ops.fields_dense_batch(regions, info["real"])
        return meta.T, val.T, info["pix_before"]

    def decode_packed(self, streams, sizes):
        """(B, l_cap) u8 streams + (B,) sizes -> (B, n_cap) int32 packed
        pixels on the pipeline's device ([:, :n_px] are valid)."""
        meta_t, val_t, pix_before = self.replay_inputs(streams, sizes)
        # (B, qb): the emits come in the rows' lane-major layout, so this
        # transpose is a view and copies nothing
        emits = rk.replay_batch(meta_t, val_t).T.contiguous()
        return place_kernel.place_fill(pix_before, emits, self.n_cap)

    def decode(self, streams, sizes, target: Optional[Channels] = None):
        """-> (B, H, W, C) uint8 images on the pipeline's device."""
        ch = int(target) if target is not None else self.channels
        packed = self.decode_packed(streams, sizes)[:, : self.n_px]
        return _unpack_images(packed, self.desc.height, self.desc.width, ch)

    # -- encode ------------------------------------------------------------

    def _encode(self, packed):
        return enc_ops.encode_batch_checked(
            self._to_device(packed, torch.int32), self.n_px, self._header,
            self.channels, chunk_cap=self.chunk_cap, out_cap=self.out_cap)

    def _raise_overflow(self, ok):
        if not bool(ok.all()):
            raise ValueError(
                "encode overflow: an image exceeded max_encode_len="
                f"{self.max_encode_len}; re-create the pipeline with a "
                "larger bound (default: worst size) for these images"
            )

    def encode_packed(self, packed):
        """(B, nb) int32 packed pixels -> ((B, out_cap) u8 streams, (B,)
        lengths).  Raises if any image overflows max_encode_len."""
        out, lengths, ok = self._encode(packed)
        self._raise_overflow(ok)
        return out, lengths

    def encode_packed_checked(self, packed):
        """Like encode_packed but returns (streams, lengths, ok) without
        raising; streams flagged not ok must be encoded again with a larger
        bound."""
        return self._encode(packed)

    def encode_packed_chunked(self, packed, sub: int = 32):
        """Whole-batch encode in sub-batches of `sub` images, which bounds
        the memory of the per-row planes.  Returns (streams, lengths, ok)
        like encode_packed_checked.  B must be a multiple of `sub`."""
        b = packed.shape[0]
        if b % sub:
            raise ValueError(f"batch {b} not a multiple of sub={sub}")
        parts = [self._encode(packed[i : i + sub]) for i in range(0, b, sub)]
        return tuple(torch.cat(x) for x in zip(*parts))

    def raw_to_packed(self, raws):
        """(B, n_px*C) uint8 -> (B, nb) int32 pixel words, zero past
        n_px: the encoder's input."""
        raws = self._to_device(raws, torch.uint8)
        with tracing.span("encode.pack"):
            tracing.count("pack_px", raws.shape[0] * self.n_px)
            tracing.count("pack_bytes", raws.numel())
            packed = pixels_to_packed(raws, self.channels)
            pad = self.nb - self.n_px
            if pad:
                packed = torch.nn.functional.pad(packed, (0, pad))
            return packed

    def encode_raw_checked(self, raws):
        """(B, n_px*C) uint8 -> (streams, lengths, ok): pixel packing,
        padding to nb and encode."""
        return self._encode(self.raw_to_packed(raws))

    def encode(self, raws):
        """(B, H, W, C) or (B, n_px*C) uint8 -> (streams, lengths)."""
        raws = torch.as_tensor(raws)
        out, lengths, ok = self.encode_raw_checked(
            raws.reshape(raws.shape[0], -1))
        self._raise_overflow(ok)
        return out, lengths

    # -- host conveniences -------------------------------------------------

    def load_files(self, paths) -> Tuple[np.ndarray, np.ndarray]:
        """Native batch loader: QOI files -> ((B, l_cap) u8, (B,) i32)
        via one C pass of the native oracle."""
        return oracle.pack_files(list(paths), self.l_cap)

    @tracing.traced("host.pack_streams")
    def pack_streams(self, blobs) -> Tuple[np.ndarray, np.ndarray]:
        """List of qoi byte strings/arrays -> ((B, l_cap) u8, (B,) i32).

        On a card both arrays view pinned blocks of PyTorch's caching host
        allocator (counted as ``pack_pinned_bytes``): a block handed out
        again has its pages in place, and ``_to_device`` and
        ``utils/transfer.upload`` copy from it to the card without another
        host copy.  The arrays keep their blocks while they live."""
        b = len(blobs)
        if self.device.type == "cuda":
            out = torch.empty((b, self.l_cap), dtype=torch.uint8,
                              pin_memory=True).numpy()
            sizes = torch.empty(b, dtype=torch.int32, pin_memory=True).numpy()
            tracing.count("pack_pinned_bytes", out.nbytes + sizes.nbytes)
        else:
            out = np.zeros((b, self.l_cap), dtype=np.uint8)
            sizes = np.zeros(b, dtype=np.int32)
        pack_into(out, sizes, blobs)
        return out, sizes


def pack_into(out: np.ndarray, sizes: np.ndarray, blobs) -> None:
    """Write each stream into its row of ``out`` (B, l_cap) u8, zero the
    row past it, and its length into ``sizes`` (B,): every byte of both is
    written, whatever they held before."""
    l_cap = out.shape[1]
    for i, blob in enumerate(blobs):
        arr = np.frombuffer(bytes(blob), np.uint8) if not isinstance(
            blob, np.ndarray
        ) else blob
        if arr.size > l_cap:
            raise ValueError(
                f"stream {i}: {arr.size} bytes exceeds pipeline l_cap "
                f"{l_cap}"
            )
        out[i, : arr.size] = arr
        out[i, arr.size :] = 0
        sizes[i] = arr.size


def _unpack_images(packed, height: int, width: int, channels: int):
    with tracing.span("decode.unpack"):
        tracing.count("unpack_px", packed.numel())
        tracing.count("unpack_bytes", packed.numel() * channels)
        return packed_to_pixels(packed, channels).reshape(
            packed.shape[0], height, width, channels)
