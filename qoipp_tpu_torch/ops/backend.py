"""One-shot device codec: one image's raw bytes to a QOI stream and back.

The counterpart of ``qoipp_tpu.ops.jax_backend``: host numpy in, host
numpy out, every stage on one device (None means "cuda").  Encode pads the
image to the JAX package's pixel bucket and runs the batch encoder at B=1
(E1 fields, K3 compact, K4 emit); decode is ops/decode.decode_single (K1 on one lane,
K6 log-fill on opaque images).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import Channels, Desc, write_header
from . import decode as dec_ops
from . import encode as enc_ops
from .bitops import pixels_to_packed


def encode_inputs(raw, desc: Desc, device):
    """One image's raw bytes -> the batch encoder's input at B=1: (1, nb)
    int32 pixel words, nb the JAX package's pixel bucket, and the (14,)
    uint8 header, on ``device``."""
    dev = torch.device(device)
    channels = int(desc.channels)
    n_px = desc.width * desc.height
    nb = enc_ops.bucket_size(n_px)
    px = np.zeros((nb, channels), dtype=np.uint8)
    px[:n_px] = np.asarray(raw, dtype=np.uint8).reshape(n_px, channels)
    packed = pixels_to_packed(torch.from_numpy(px.reshape(-1)).to(dev),
                              channels)
    header = torch.from_numpy(
        np.frombuffer(write_header(desc), dtype=np.uint8).copy()).to(dev)
    return packed[None], header


def encode_single(raw, desc: Desc, device=None) -> np.ndarray:
    """Encode one image's raw bytes -> QOI byte stream (numpy), bit-exact
    with the reference encoder."""
    dev = torch.device("cuda" if device is None else device)
    packed, header = encode_inputs(raw, desc, dev)
    out, total_len, _ = enc_ops.encode_batch_checked(
        packed, desc.width * desc.height, header, int(desc.channels))
    return out[0, : int(total_len[0])].cpu().numpy()


def decode_single(data, desc: Desc, dst_channels: Channels,
                  device=None) -> np.ndarray:
    """Decode one QOI byte stream -> raw bytes (numpy), bit-exact with the
    reference decoder for every input, truncated streams included."""
    return dec_ops.decode_single(data, desc, dst_channels, device=device)
