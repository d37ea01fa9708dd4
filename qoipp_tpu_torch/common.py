"""QOI types, constants and header I/O of the port's host layer.

A copy of what the port needs from ``qoipp_tpu.common``, kept here so the
port imports nothing of the JAX package: the same enums, the same ``Desc``,
the same 14-byte header on both sides.  Pure Python and numpy.
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Generic, Optional, TypeVar, Union

import numpy as np

MAGIC = b"qoif"
HEADER_SIZE = 14
END_MARKER = bytes([0, 0, 0, 0, 0, 0, 0, 1])
END_MARKER_SIZE = 8
_SIZE_T_MAX = 2**64 - 1


class Colorspace(enum.IntEnum):
    """Image colorspace; informational only."""

    SRGB = 0
    LINEAR = 1

    sRGB = 0
    Linear = 1


class Channels(enum.IntEnum):
    """Bytes per pixel."""

    RGB = 3
    RGBA = 4


class Error(enum.IntEnum):
    """The codec's error codes (the values of ``qoipp_tpu.common.Error``)."""

    EMPTY = 1
    TOO_SHORT = 2
    TOO_BIG = 3
    NOT_QOI = 4
    INVALID_DESC = 5
    MISMATCHED_DESC = 6
    NOT_ENOUGH_SPACE = 7
    NOT_INITIALIZED = 8
    ALREADY_INITIALIZED = 9
    NOT_REGULAR_FILE = 10
    FILE_EXISTS = 11
    FILE_NOT_EXISTS = 12
    IO_ERROR = 13
    BAD_ALLOC = 14


@dataclass(frozen=True)
class Desc:
    """QOI image description."""

    width: int
    height: int
    channels: Channels
    colorspace: Colorspace = Colorspace.SRGB


T = TypeVar("T")


class Result(Generic[T]):
    """A value or an Error; truthy iff it holds a value."""

    __slots__ = ("_value", "_error")

    def __init__(self, value: Optional[T] = None,
                 error: Optional[Error] = None):
        if (value is None) == (error is None):
            raise ValueError("Result holds exactly one of value/error")
        self._value = value
        self._error = error

    @staticmethod
    def ok(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def err(error: Error) -> "Result[T]":
        return Result(error=error)

    def __bool__(self) -> bool:
        return self._error is None

    def value(self) -> T:
        if self._error is not None:
            raise ValueError(f"Result holds error: {self._error.name}")
        return self._value  # type: ignore[return-value]

    def error(self) -> Error:
        if self._error is None:
            raise ValueError("Result holds a value, not an error")
        return self._error


def _to_channels(c: int) -> Optional[Channels]:
    return Channels(c) if c in (3, 4) else None


def _to_colorspace(c: int) -> Optional[Colorspace]:
    return Colorspace(c) if c in (0, 1) else None


def is_valid(desc: Desc) -> bool:
    return (desc.width > 0 and desc.height > 0
            and desc.channels in (Channels.RGB, Channels.RGBA)
            and desc.colorspace in (Colorspace.SRGB, Colorspace.LINEAR))


def count_bytes(desc: Desc) -> Result[int]:
    """Raw byte count of the image described by desc, with the reference's
    size_t overflow checks."""
    if not is_valid(desc):
        return Result.err(Error.INVALID_DESC)
    pixel_count = desc.width * desc.height
    if pixel_count > _SIZE_T_MAX:
        return Result.err(Error.TOO_BIG)
    total = pixel_count * int(desc.channels)
    if total > _SIZE_T_MAX:
        return Result.err(Error.TOO_BIG)
    return Result.ok(total)


def worst_size(desc: Desc) -> Result[int]:
    """Worst-case encoded size: every pixel uncompressed plus its tag
    byte, the header and the end marker; count_bytes' errors where the
    raw image already overflows size_t."""
    raw = count_bytes(desc)
    if not raw:
        return Result.err(raw.error())
    return Result((int(desc.channels) + 1) * desc.width * desc.height
                  + HEADER_SIZE + END_MARKER_SIZE)


def write_header(desc: Desc) -> bytes:
    """The 14-byte QOI header: magic, big-endian width and height,
    channels, colorspace."""
    return (MAGIC + struct.pack(">II", desc.width, desc.height)
            + bytes([int(desc.channels), int(desc.colorspace)]))


def read_header(data: Union[bytes, bytearray, memoryview, np.ndarray, str,
                            os.PathLike]) -> Result[Desc]:
    """Parse and validate the QOI header at the start of ``data``, or of
    the file at a ``str`` or ``os.PathLike`` path: FILE_NOT_EXISTS,
    NOT_REGULAR_FILE, or IO_ERROR where the file cannot be read or holds
    fewer than 14 bytes."""
    if isinstance(data, (str, os.PathLike)):
        path = Path(data)
        if not path.exists():
            return Result(error=Error.FILE_NOT_EXISTS)
        if not path.is_file():
            return Result(error=Error.NOT_REGULAR_FILE)
        try:
            with open(path, "rb") as f:
                data = f.read(HEADER_SIZE)
        except OSError:
            return Result(error=Error.IO_ERROR)
        if len(data) < HEADER_SIZE:
            return Result(error=Error.IO_ERROR)
    head = data[:HEADER_SIZE]
    data = head.tobytes() if isinstance(head, np.ndarray) else bytes(head)
    if len(data) == 0:
        return Result(error=Error.EMPTY)
    if len(data) < HEADER_SIZE:
        return Result(error=Error.TOO_SHORT)
    if data[:4] != MAGIC:
        return Result(error=Error.NOT_QOI)
    width, height = struct.unpack(">II", data[4:12])
    channels = _to_channels(data[12])
    colorspace = _to_colorspace(data[13])
    if channels is None or colorspace is None or width == 0 or height == 0:
        return Result(error=Error.INVALID_DESC)
    return Result(Desc(width, height, channels, colorspace))
