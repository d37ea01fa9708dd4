"""QOI types, constants, validation and header I/O of the port's host layer.

A copy of ``qoipp_tpu.common``, kept here so the port imports nothing of
the JAX package: the same enums, value types, ``Result``, size math and
the same 14-byte header on both sides.  Pure Python and numpy.
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Generic, Iterator, Optional, TypeVar, Union

import numpy as np

MAGIC = b"qoif"
HEADER_SIZE = 14
END_MARKER = bytes([0, 0, 0, 0, 0, 0, 0, 1])
END_MARKER_SIZE = 8
RUNNING_ARRAY_SIZE = 64
RUN_LIMIT = 62

# op tags
OP_RGB = 0xFE
OP_RGBA = 0xFF
OP_INDEX = 0x00
OP_DIFF = 0x40
OP_LUMA = 0x80
OP_RUN = 0xC0

# biases and the DIFF/LUMA ranges
BIAS_OP_RUN = -1
BIAS_OP_DIFF = 2
BIAS_OP_LUMA_G = 32
BIAS_OP_LUMA_RB = 8
MIN_DIFF, MAX_DIFF = -2, 1
MIN_LUMA_G, MAX_LUMA_G = -32, 31
MIN_LUMA_RB, MAX_LUMA_RB = -8, 7

# the codec's start pixel
START_PIXEL = (0x00, 0x00, 0x00, 0xFF)

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


_ERROR_STRINGS = {
    Error.EMPTY: "Data is empty",
    Error.TOO_SHORT: "Data is too short",
    Error.TOO_BIG: "Image is too big to process",
    Error.NOT_QOI: "Not a QOI file",
    Error.INVALID_DESC: "Image description is invalid",
    Error.MISMATCHED_DESC: "Image description does not match the data",
    Error.NOT_ENOUGH_SPACE: "Buffer does not have enough space",
    Error.NOT_REGULAR_FILE: "Not a regular file",
    Error.FILE_EXISTS: "File already exists",
    Error.FILE_NOT_EXISTS: "File does not exist",
    Error.IO_ERROR: "Unable to do read or write operation",
    Error.BAD_ALLOC: "Failed to allocate memory",
    Error.NOT_INITIALIZED: "Stream encoder/decoder is not initialized yet",
    Error.ALREADY_INITIALIZED: "Stream encoder/decoder already initialized",
}


def to_string(error: Error) -> str:
    """Human-readable description of an error code."""
    return _ERROR_STRINGS.get(error, "Unknown")


def to_channels(channels: int) -> Optional[Channels]:
    """3/4 -> Channels, else None."""
    return Channels(channels) if channels in (3, 4) else None


def to_colorspace(colorspace: int) -> Optional[Colorspace]:
    """0/1 -> Colorspace, else None."""
    return Colorspace(colorspace) if colorspace in (0, 1) else None


@dataclass(frozen=True)
class Pixel:
    """One RGBA pixel."""

    r: int
    g: int
    b: int
    a: int = 0xFF

    def __iter__(self) -> Iterator[int]:
        return iter((self.r, self.g, self.b, self.a))


@dataclass(frozen=True)
class Desc:
    """QOI image description."""

    width: int
    height: int
    channels: Channels
    colorspace: Colorspace = Colorspace.SRGB

    def replace(self, **kw) -> "Desc":
        d = dict(width=self.width, height=self.height,
                 channels=self.channels, colorspace=self.colorspace)
        d.update(kw)
        return Desc(**d)


@dataclass
class Image:
    """Raw decoded bytes (1-D uint8, width * height * channels long) and
    their description."""

    data: np.ndarray
    desc: Desc


@dataclass(frozen=True)
class EncodeStatus:
    """Result of a (possibly partial) encode_into."""

    written: int
    complete: bool


@dataclass(frozen=True)
class StreamResult:
    """Bytes processed and written by one streaming call."""

    processed: int
    written: int


T = TypeVar("T")


class Result(Generic[T]):
    """A value or an Error; truthy iff it holds a value.  ``value()``
    raises on an error, ``error()`` on a value."""

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

    def has_value(self) -> bool:
        return self._error is None

    def __bool__(self) -> bool:
        return self.has_value()

    def value(self) -> T:
        if self._error is not None:
            raise ValueError(f"Result holds error: {to_string(self._error)}")
        return self._value  # type: ignore[return-value]

    def error(self) -> Error:
        if self._error is None:
            raise ValueError("Result holds a value, not an error")
        return self._error

    def value_or(self, default: T) -> T:
        return self._value if self._error is None else default  # type: ignore

    def __repr__(self) -> str:
        if self._error is None:
            return f"Result.ok({self._value!r})"
        return f"Result.err({self._error!r})"


def make_result(value: T) -> Result[T]:
    return Result.ok(value)


def make_error(error: Error) -> Result:
    return Result.err(error)


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


BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]


def write_header(desc: Desc) -> bytes:
    """The 14-byte QOI header: magic, big-endian width and height,
    channels, colorspace."""
    return (MAGIC + struct.pack(">II", desc.width, desc.height)
            + bytes([int(desc.channels), int(desc.colorspace)]))


def read_header(data: Union[BytesLike, str, os.PathLike]) -> Result[Desc]:
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
    channels = to_channels(data[12])
    colorspace = to_colorspace(data[13])
    if channels is None or colorspace is None or width == 0 or height == 0:
        return Result(error=Error.INVALID_DESC)
    return Result(Desc(width, height, channels, colorspace))


# callback types of the pixel generator, pixel sink and byte sink overloads
PixelGenFun = Callable[[int], Pixel]
PixelSinkFun = Callable[[Pixel], None]
ByteSinkFun = Callable[[int], None]
