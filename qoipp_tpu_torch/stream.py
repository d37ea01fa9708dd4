"""Streaming (bounded-state, resumable) QOI codecs on the host.

The port of ``qoipp_tpu.stream``: the reference's StreamEncoder and
StreamDecoder contracts (zero allocation per call, whole-chunk and
whole-pixel granularity, rollback when the output buffer fills, the
pending OP_RUN drain, StreamResult{processed, written}).  The state
machine runs in the native codec (native/qoi_ref.cpp) through
``oracle.NativeStreamState``.  The device-resident windowed codec for
multi-MB images is ``ops/device_stream.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .common import (
    END_MARKER_SIZE,
    HEADER_SIZE,
    Channels,
    Colorspace,
    Desc,
    Error,
    Result,
    StreamResult,
    count_bytes,
)
from .oracle import NativeStreamState, _ptr


def _u8view(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        if buf.dtype != np.uint8:
            raise TypeError(f"buffer dtype {buf.dtype}, expected uint8")
        return buf.reshape(-1)
    return np.frombuffer(bytes(buf), dtype=np.uint8)


def _expect(cond: bool, what: str, rc) -> None:
    if not cond:
        raise RuntimeError(f"{what} returned {rc}")


class StreamEncoder:
    """Resumable chunked QOI encoder with bounded state.

    Lifecycle: initialize() -> encode()* -> finalize()
    (reference: include/qoipp/stream.hpp:23-116).
    """

    def __init__(self):
        self._state = NativeStreamState()
        self._channels: Optional[Channels] = None

    # -- accessors ----------------------------------------------------------
    def is_initialized(self) -> bool:
        return self._channels is not None

    def channels(self) -> Optional[Channels]:
        return self._channels

    def has_run_count(self) -> bool:
        return self._state.run_count() > 0

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, out_buf: np.ndarray, desc: Desc) -> Result[int]:
        """Write the 14-byte header into out_buf and arm the encoder
        (reference: stream.cpp:113-136)."""
        if self._channels is not None:
            return Result.err(Error.ALREADY_INITIALIZED)
        out = _u8view(out_buf)
        if out.size == 0:
            return Result.err(Error.EMPTY)
        if out.size < HEADER_SIZE:
            return Result.err(Error.TOO_SHORT)
        bc = count_bytes(desc)
        if not bc:
            return Result.err(bc.error())

        rc = self._state.lib.qoiref_enc_initialize(
            self._state.handle, _ptr(out), out.size,
            desc.width, desc.height, int(desc.channels), int(desc.colorspace),
        )
        _expect(rc == HEADER_SIZE, "qoiref_enc_initialize", rc)
        self._channels = desc.channels
        return Result.ok(HEADER_SIZE)

    def encode(self, out_buf: np.ndarray, in_buf) -> Result[StreamResult]:
        """Consume whole pixels from in_buf, emit whole chunks into out_buf.
        Returns bytes processed/written; caller re-calls with the remainder
        (reference: stream.cpp:138-239)."""
        if self._channels is None:
            return Result.err(Error.NOT_INITIALIZED)
        out = _u8view(out_buf)
        inp = _u8view(in_buf)
        if out.size == 0 or inp.size == 0:
            return Result.err(Error.EMPTY)
        if out.size < 5:  # OP_RGBA needs 5 bytes
            return Result.err(Error.TOO_SHORT)

        processed = ctypes.c_uint64(0)
        written = ctypes.c_uint64(0)
        rc = self._state.lib.qoiref_enc_encode(
            self._state.handle, _ptr(out), out.size, _ptr(inp), inp.size,
            ctypes.byref(processed), ctypes.byref(written),
        )
        _expect(rc == 0, "the native stream codec", rc)
        return Result.ok(StreamResult(int(processed.value), int(written.value)))

    def finalize(self, out_buf: np.ndarray) -> Result[int]:
        """Flush the pending run (if any) + end marker, reset all state
        (reference: stream.cpp:241-267)."""
        if self._channels is None:
            return Result.err(Error.NOT_INITIALIZED)
        out = _u8view(out_buf)
        if out.size == 0:
            return Result.err(Error.EMPTY)
        if out.size < END_MARKER_SIZE + (1 if self.has_run_count() else 0):
            return Result.err(Error.TOO_SHORT)
        rc = self._state.lib.qoiref_enc_finalize(self._state.handle, _ptr(out), out.size)
        _expect(rc > 0, "qoiref_enc_finalize", rc)
        self._channels = None
        return Result.ok(int(rc))

    def reset(self) -> None:
        """Abort the stream; no-op when not initialized
        (reference: stream.cpp:269-277)."""
        if self._channels is not None:
            self._state.reset()
            self._channels = None


class StreamDecoder:
    """Resumable chunked QOI decoder with bounded state.

    Lifecycle: initialize() -> decode()* -> drain_run()* -> reset()
    (reference: include/qoipp/stream.hpp:133-244).
    """

    def __init__(self):
        self._state = NativeStreamState()
        self._initialized = False
        self._target: Optional[Channels] = None

    # -- accessors ----------------------------------------------------------
    def is_initialized(self) -> bool:
        return self._initialized

    def channels(self) -> Optional[Channels]:
        # Reference behavior: m_channels is assigned the target in
        # initialize() (stream.cpp:302-304), so both accessors observe it.
        return self._target

    def target(self) -> Optional[Channels]:
        return self._target

    def has_run_count(self) -> bool:
        return self._state.run_count() > 0

    def run_count(self) -> int:
        return self._state.run_count()

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, in_buf, target: Optional[Channels] = None) -> Result[Desc]:
        """Parse the header, seed the running array with the start pixel
        (reference: stream.cpp:290-310)."""
        if self._initialized:
            return Result.err(Error.ALREADY_INITIALIZED)
        inp = _u8view(in_buf)
        if inp.size == 0:
            return Result.err(Error.EMPTY)
        if inp.size < HEADER_SIZE:
            return Result.err(Error.TOO_SHORT)

        w = ctypes.c_uint32(0)
        h = ctypes.c_uint32(0)
        ch = ctypes.c_uint8(0)
        cs = ctypes.c_uint8(0)
        rc = self._state.lib.qoiref_dec_initialize(
            self._state.handle, _ptr(inp), inp.size,
            int(target) if target is not None else 0,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch), ctypes.byref(cs),
        )
        if rc == -2:
            return Result.err(Error.NOT_QOI)
        if rc == -3:
            return Result.err(Error.INVALID_DESC)
        if rc != 0:
            return Result.err(Error.TOO_SHORT)

        self._target = Channels(self._state.target())
        self._initialized = True
        desc = Desc(w.value, h.value, self._target, Colorspace(cs.value))
        bc = count_bytes(desc)
        if not bc:
            self._state.reset()
            self._initialized = False
            self._target = None
            return Result.err(bc.error())
        return Result.ok(desc)

    def decode(self, out_buf: np.ndarray, in_buf) -> Result[StreamResult]:
        """Decode whole chunks; a chunk split across the input boundary stays
        unconsumed, a pending OP_RUN persists in state
        (reference: stream.cpp:312-424)."""
        if not self._initialized:
            return Result.err(Error.NOT_INITIALIZED)
        out = _u8view(out_buf)
        inp = _u8view(in_buf)
        if out.size == 0 or inp.size == 0:
            return Result.err(Error.EMPTY)
        if out.size < int(self._target):
            return Result.err(Error.TOO_SHORT)

        processed = ctypes.c_uint64(0)
        written = ctypes.c_uint64(0)
        rc = self._state.lib.qoiref_dec_decode(
            self._state.handle, _ptr(out), out.size, _ptr(inp), inp.size,
            ctypes.byref(processed), ctypes.byref(written),
        )
        _expect(rc == 0, "the native stream codec", rc)
        return Result.ok(StreamResult(int(processed.value), int(written.value)))

    def drain_run(self, out_buf: np.ndarray) -> Result[int]:
        """Emit pixels still owed by a pending OP_RUN (up to 62 pixels =
        186/248 bytes) — reference: stream.cpp:426-447."""
        if not self._initialized:
            return Result.err(Error.NOT_INITIALIZED)
        out = _u8view(out_buf)
        if out.size == 0:
            return Result.err(Error.EMPTY)
        rc = self._state.lib.qoiref_dec_drain_run(self._state.handle, _ptr(out), out.size)
        _expect(rc >= 0, "qoiref_dec_drain_run", rc)
        return Result.ok(int(rc))

    def reset(self) -> None:
        """Reset for reuse; no-op when not initialized
        (reference: stream.cpp:449-458)."""
        if self._initialized:
            self._state.reset()
            self._initialized = False
            self._target = None
