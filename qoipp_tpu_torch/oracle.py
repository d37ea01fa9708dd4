"""ctypes binding of the native CPU reference codec (native/qoi_ref.cpp).

The port's bit-exact reference, its host-side split planner and the
state machine of the byte-granular streaming codec (``stream.py``).  On
first use the source is compiled with g++ into
``build/qoipp_tpu_torch/libqoiref.so`` at the root of the checkout
(rebuilt when the source is newer) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .common import Channels, Colorspace, Desc

_ROOT = Path(__file__).resolve().parents[1]
SRC = _ROOT / "native" / "qoi_ref.cpp"
LIB_PATH = _ROOT / "build" / "qoipp_tpu_torch" / "libqoiref.so"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_U64, _U32, _U8, _D = (ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint8,
                       ctypes.c_double)
_I, _I64, _P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_u32p, _u8out = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {  # name -> (restype, argtypes)
    "qoiref_encode": (_U64, [_u8p, _U32, _U32, _U8, _U8, _u8p, _U64,
                             ctypes.POINTER(ctypes.c_int)]),
    "qoiref_decode": (None, [_u8p, _U64, _U32, _U32, _U8, _U8, _u8p]),
    "qoiref_pack_files": (_U64, [ctypes.POINTER(ctypes.c_char_p), _U64,
                                 _u8p, _U64, _u64p]),
    "qoiref_split_points": (_U64, [_u8p, _U64, _U64, _U64, _D, _D, _U64,
                                   ctypes.c_int, _u64p, _u64p, _u64p, _D]),
    "qoiref_read_header": (_I, [_u8p, _U64, _u32p, _u32p, _u8out, _u8out]),
    "qoiref_flip_vertical": (None, [_u8p, _U32, _U32, _U8]),
    # the streaming codec's state blob (StreamEncoder, StreamDecoder)
    "qoiref_stream_state_size": (_U64, []),
    "qoiref_stream_reset": (None, [_P]),
    "qoiref_enc_initialize": (_I64, [_P, _u8p, _U64, _U32, _U32, _U8, _U8]),
    "qoiref_enc_encode": (_I, [_P, _u8p, _U64, _u8p, _U64, _u64p, _u64p]),
    "qoiref_enc_finalize": (_I64, [_P, _u8p, _U64]),
    "qoiref_dec_initialize": (_I, [_P, _u8p, _U64, _U8, _u32p, _u32p, _u8out,
                                   _u8out]),
    "qoiref_dec_decode": (_I, [_P, _u8p, _U64, _u8p, _U64, _u64p, _u64p]),
    "qoiref_dec_drain_run": (_I64, [_P, _u8p, _U64]),
    "qoiref_dec_run_count": (_U32, [_P]),
    "qoiref_stream_channels": (_U8, [_P]),
    "qoiref_dec_target": (_U8, [_P]),
    "qoiref_stream_is_initialized": (_I, [_P]),
}


def build() -> Path:
    """Compile the reference codec if the library is missing or stale."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime:
        return LIB_PATH
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f".libqoiref.{os.getpid()}.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: no process loads half a library
    return LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _np_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _u64_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_u64p)


def encode(pixels, desc: Desc, out_cap: Optional[int] = None
           ) -> Tuple[np.ndarray, bool]:
    """Encode raw pixels -> (qoi bytes, complete); out_cap bounds the
    output (default: the worst case)."""
    lib = _load()
    arr = _np_u8(pixels)
    need = desc.width * desc.height * int(desc.channels)
    if arr.size < need:
        raise ValueError(f"pixel buffer too small: {arr.size} < {need}")
    if out_cap is None:
        out_cap = (int(desc.channels) + 1) * desc.width * desc.height + 22
    out = np.empty(out_cap, dtype=np.uint8)
    complete = ctypes.c_int(0)
    n = lib.qoiref_encode(_ptr(arr), desc.width, desc.height,
                          int(desc.channels), int(desc.colorspace),
                          _ptr(out), out_cap, ctypes.byref(complete))
    return out[: int(n)], bool(complete.value)


def decode(data, desc: Desc, dst_channels: Channels) -> np.ndarray:
    """Tolerant decode of a whole qoi byte stream into raw pixels."""
    lib = _load()
    arr = _np_u8(data)
    out = np.zeros(desc.width * desc.height * int(dst_channels), np.uint8)
    lib.qoiref_decode(_ptr(arr), arr.size, desc.width, desc.height,
                      int(desc.channels), int(dst_channels), _ptr(out))
    return out


def read_header(data) -> Optional[Desc]:
    """The native header parser: the Desc, or None where the header is
    invalid."""
    lib = _load()
    arr = _np_u8(data)
    w, h = ctypes.c_uint32(0), ctypes.c_uint32(0)
    ch, cs = ctypes.c_uint8(0), ctypes.c_uint8(0)
    rc = lib.qoiref_read_header(_ptr(arr), arr.size, ctypes.byref(w),
                                ctypes.byref(h), ctypes.byref(ch),
                                ctypes.byref(cs))
    if rc != 0:
        return None
    return Desc(w.value, h.value, Channels(ch.value), Colorspace(cs.value))


def flip_vertical(data: np.ndarray, desc: Desc) -> np.ndarray:
    """A copy of raw pixels with the rows in reverse order."""
    lib = _load()
    arr = np.ascontiguousarray(data, dtype=np.uint8).copy()
    lib.qoiref_flip_vertical(_ptr(arr), desc.width, desc.height,
                             int(desc.channels))
    return arr


class NativeStreamState:
    """Owns one native stream state blob, the whole carry of the
    byte-granular streaming codec; stream.StreamEncoder and StreamDecoder
    drive it."""

    def __init__(self):
        self._lib = _load()
        size = self._lib.qoiref_stream_state_size()
        self._blob = ctypes.create_string_buffer(int(size))
        self._lib.qoiref_stream_reset(self._blob)

    @property
    def lib(self):
        return self._lib

    @property
    def handle(self):
        return self._blob

    def reset(self):
        self._lib.qoiref_stream_reset(self._blob)

    def is_initialized(self) -> bool:
        return bool(self._lib.qoiref_stream_is_initialized(self._blob))

    def run_count(self) -> int:
        return int(self._lib.qoiref_dec_run_count(self._blob))

    def channels(self) -> int:
        return int(self._lib.qoiref_stream_channels(self._blob))

    def target(self) -> int:
        return int(self._lib.qoiref_dec_target(self._blob))


def split_points(body, n_px: int, n_segments: int, byte_w: float = 1.0,
                 px_w: float = 0.0, lookahead: int = 0,
                 prefer_rgba: bool = False, chunk_w: float = 0.0):
    """Cut a QOI body (the bytes after the header, stream size - 22 long)
    into cost-balanced segments on chunk boundaries.  Returns
    (byte_offsets, px_offsets, chunk_ordinals), int64 arrays of n+1
    entries.  A chunk costs byte_w * bytes + chunk_w + px_w * pixels; with
    lookahead > 0 each cut slides up to that many bytes to the next
    OP_RGB (OP_RGBA with prefer_rgba) chunk, so segments open with an
    absolute colour.  chunk_ordinals[k] is segment k's first chunk's index
    in the stream."""
    lib = _load()
    arr = _np_u8(body)
    offs, pxs, cis = (np.zeros(n_segments + 1, np.uint64) for _ in range(3))
    n = int(lib.qoiref_split_points(
        _ptr(arr), arr.size, n_px, n_segments, byte_w, px_w, lookahead,
        1 if prefer_rgba else 0, _u64_ptr(offs), _u64_ptr(pxs),
        _u64_ptr(cis), chunk_w))
    return tuple(x[: n + 1].astype(np.int64) for x in (offs, pxs, cis))


def pack_files(paths, row: int):
    """Read QOI files into a zero-padded (B, row) uint8 array plus (B,)
    int32 sizes in one native pass.  Raises on an unreadable or oversized
    file."""
    lib = _load()
    n = len(paths)
    out = np.zeros((n, row), dtype=np.uint8)
    sizes = np.zeros(n, dtype=np.uint64)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.qoiref_pack_files(names, n, _ptr(out.reshape(-1)), row,
                               _u64_ptr(sizes))
    if rc != 0:
        raise OSError(f"failed to load {paths[int(rc) - 1]}")
    return out, sizes.astype(np.int32)
