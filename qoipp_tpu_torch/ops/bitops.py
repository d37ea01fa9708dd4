"""Packed-pixel bit manipulation on int32 words.

A pixel is the uint32 word r | g<<8 | b<<16 | a<<24, held in a
``torch.int32`` tensor (torch has no uint32 shifts, adds or compares).  The
bits are the JAX package's; only two things differ: constants above 2^31
are written as their int32 value, and ``>>`` is arithmetic on int32, so
every right shift is masked.
"""

from __future__ import annotations

import torch

START_PIXEL_PACKED = -(1 << 24)  # 0xFF000000 as int32: (0, 0, 0, 255)
ALPHA_MASK = -(1 << 24)  # 0xFF000000 as int32


def pack_rgba(r, g, b, a):
    """Pack channel values in [0, 255] (any integer dtype) into int32 words."""
    r, g, b, a = (x.to(torch.int32) for x in (r, g, b, a))
    return r | (g << 8) | (b << 16) | (a << 24)


def unpack_channel(p, c: int):
    """Channel c (0=r, 1=g, 2=b, 3=a) of int32 words, in [0, 255]."""
    return (p >> (8 * c)) & 0xFF


def unpack_rgba(p):
    """The four channels (r, g, b, a) of int32 words, each in [0, 255]."""
    return tuple(unpack_channel(p, c) for c in range(4))


def hash6(p):
    """QOI running-index hash (3r + 5g + 7b + 11a) % 64 of packed words."""
    return (
        unpack_channel(p, 0) * 3 + unpack_channel(p, 1) * 5
        + unpack_channel(p, 2) * 7 + unpack_channel(p, 3) * 11
    ) & 63


def swar_add_bytes(x, y):
    """Per-byte wraparound addition of two packed pixel words."""
    lo = ((x & 0x00FF00FF) + (y & 0x00FF00FF)) & 0x00FF00FF
    hi = (((x >> 8) & 0x00FF00FF) + ((y >> 8) & 0x00FF00FF)) & 0x00FF00FF
    return lo | (hi << 8)


def to_int8(x):
    """The low byte of x as a signed value in [-128, 127] (the reference's
    i8 narrowing casts)."""
    return (((x.to(torch.int32) & 0xFF) + 128) & 0xFF) - 128


def pixels_to_packed(raw, channels: int):
    """(..., N*channels) uint8 -> (..., N) int32 words (RGB gets a=255)."""
    px = raw.reshape(*raw.shape[:-1], -1, channels)
    a = px[..., 3] if channels == 4 else torch.full_like(px[..., 0], 255)
    return pack_rgba(px[..., 0], px[..., 1], px[..., 2], a)


def packed_to_pixels(packed, channels: int):
    """(..., N) int32 words -> (..., N*channels) uint8."""
    chans = [unpack_channel(packed, c).to(torch.uint8) for c in range(channels)]
    return torch.stack(chans, dim=-1).reshape(*packed.shape[:-1], -1)
