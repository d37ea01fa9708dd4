"""One-shot QOI encode/decode public API.

The port of ``qoipp_tpu.api``: the reference's public overloads
(encode/encode_into/decode/decode_into over memory buffers, pixel and byte
callbacks, and files) with the same Result-based error contracts.  Backends:

- ``native``: the C++ reference codec on the host (bit-exact, sequential).
- ``torch``:  the one-shot device codec (``ops/backend.py``: decode runs
  K1 and K6, encode K3 and K4) on ``device``, None meaning "cuda"; with no
  card it raises, it never runs natively instead.
- ``auto``:   ``torch`` for images of at least ONESHOT_DEVICE_THRESHOLD
  pixels where a CUDA device is present, native otherwise.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np

from . import oracle
from .common import (
    END_MARKER_SIZE,
    HEADER_SIZE,
    BytesLike,
    Channels,
    Desc,
    EncodeStatus,
    Error,
    Image,
    Pixel,
    Result,
    count_bytes,
    read_header,
    worst_size,
)

PathLike = Union[str, os.PathLike]


def _as_u8(data: BytesLike) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1), dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _materialize_gen(gen: Callable[[int], Pixel], desc: Desc) -> np.ndarray:
    """Pull pixels from a generator callback into a raw buffer
    (reference: FuncPixelReader, source/util.hpp:322-337 — RGB forces a=0xFF).

    Fast path: a generator that accepts an int64 index *array* and returns
    an (N, 4)-shaped uint8-convertible array is called once per 1M-pixel
    block (array-in/array-out in place of the reference's per-pixel
    virtual calls).  Scalar generators fall back to the per-pixel loop.

    Dispatch: an explicit ``gen.vectorized`` bool attribute wins; without
    one, a single probe call with indices [0..3] decides, and its result is
    REUSED for those pixels so every index is evaluated exactly once on the
    fast path (a stateful *scalar* generator that also tolerates array input
    should set ``vectorized = False`` to skip the probe entirely).
    """
    n = desc.width * desc.height
    ch = int(desc.channels)

    vec_attr = getattr(gen, "vectorized", None)
    probe = None
    if isinstance(vec_attr, bool):
        vectorized = vec_attr
    else:
        k = min(n, 4)
        try:
            probe = np.asarray(gen(np.arange(k, dtype=np.int64)))
            vectorized = probe.shape == (k, 4)
        except Exception:
            probe = None
            vectorized = False
    if vectorized:
        out = np.empty((n, ch), dtype=np.uint8)
        start = 0
        if probe is not None:
            start = probe.shape[0]
            out[:start] = probe.astype(np.uint8)[:, :ch]
        blk = 1 << 20
        for s in range(start, n, blk):
            ids = np.arange(s, min(s + blk, n), dtype=np.int64)
            px = np.asarray(gen(ids), dtype=np.uint8)
            out[s : s + ids.size] = px[:, :ch]
        return out.reshape(-1)

    out = np.empty((n, ch), dtype=np.uint8)
    for i in range(n):
        p = gen(i)
        r, g, b, a = int(p.r), int(p.g), int(p.b), int(p.a)
        if ch == 3:
            out[i, 0], out[i, 1], out[i, 2] = r, g, b
        else:
            out[i] = (r, g, b, a)
    return out.reshape(-1)


# One-shot auto-routing threshold (pixels).  None routes every one-shot
# call native; an int routes images of at least that many pixels to the
# device where a CUDA device is present.  A one-shot call moves the raw
# pixels across the host link both ways and runs ~1,000 small launches,
# so the default stays None: on an NVIDIA H100 80GB HBM3 at 700 W
# (python -m qoipp_tpu_torch.tools.bench --sizes, warm) native is faster
# at 512x512, 1920x1080 and 3840x2160 in both directions, torch/native
# decode 35.1x, 4.82x, 1.26x and encode 5.93x, 3.23x, 3.56x; decode
# nears the crossover only past 8 MPix (PERF.md section 7).  Set it with
# set_oneshot_device_threshold() or the QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD
# environment variable (empty or "none": never).
ONESHOT_DEVICE_THRESHOLD: Optional[int] = None


def set_oneshot_device_threshold(n_pixels: Optional[int]) -> None:
    """Set the one-shot auto-routing threshold: images with at least
    ``n_pixels`` pixels route to the device under ``backend='auto'``;
    ``None`` routes every one-shot call native."""
    global ONESHOT_DEVICE_THRESHOLD
    if n_pixels is not None and n_pixels < 0:
        raise ValueError("threshold must be a nonnegative pixel count or None")
    ONESHOT_DEVICE_THRESHOLD = n_pixels


def _env_threshold() -> Optional[int]:
    raw = os.environ.get("QOIPP_TPU_ONESHOT_DEVICE_THRESHOLD")
    if raw is None or raw.strip().lower() in ("", "none"):
        return None
    return int(raw)


try:
    ONESHOT_DEVICE_THRESHOLD = _env_threshold()
except ValueError:
    ONESHOT_DEVICE_THRESHOLD = None


def _resolve_backend(backend: str, n_pixels: int) -> str:
    if backend in ("native", "torch"):
        return backend
    # auto: one-shot calls follow ONESHOT_DEVICE_THRESHOLD above, and go
    # to the device only where there is a card
    if (ONESHOT_DEVICE_THRESHOLD is not None
            and n_pixels >= ONESHOT_DEVICE_THRESHOLD):
        import torch

        if torch.cuda.is_available():
            return "torch"
    return "native"


def _device_encode(arr: np.ndarray, desc: Desc, device) -> np.ndarray:
    from .convert import resolve_device
    from .ops import backend as device_backend

    return device_backend.encode_single(arr, desc,
                                        device=resolve_device(device))


def _device_decode(arr: np.ndarray, desc: Desc, channels: Channels,
                   device) -> np.ndarray:
    from .convert import resolve_device
    from .ops import backend as device_backend

    return device_backend.decode_single(arr, desc, channels,
                                        device=resolve_device(device))


# --------------------------------------------------------------------------
# encode — full-buffer result (reference: source/simple.cpp:178-229)
# --------------------------------------------------------------------------


def encode(
    input_data: Union[BytesLike, Callable[[int], Pixel]],
    desc: Desc,
    *,
    backend: str = "auto",
    device=None,
) -> Result[np.ndarray]:
    """Encode raw pixels (buffer or pixel-generator callback) to a new QOI
    byte buffer.

    Errors: EMPTY (zero-length input), INVALID_DESC/TOO_BIG (bad desc),
    MISMATCHED_DESC (buffer size != desc byte count) — reference:
    source/simple.cpp:182-195.
    """
    from_gen = callable(input_data)
    if not from_gen:
        arr = _as_u8(input_data)
        if arr.size == 0:
            return Result.err(Error.EMPTY)

    bc = count_bytes(desc)
    if not bc:
        return Result.err(bc.error())

    if from_gen:
        arr = _materialize_gen(input_data, desc)
    elif arr.size != bc.value():
        return Result.err(Error.MISMATCHED_DESC)

    be = _resolve_backend(backend, desc.width * desc.height)
    if be == "torch":
        return Result.ok(_device_encode(arr, desc, device))
    out, complete = oracle.encode(arr, desc)
    if not complete:
        raise RuntimeError("the native encoder stopped short of a "
                           "worst-size buffer")
    return Result.ok(out)


# --------------------------------------------------------------------------
# encode_into — preallocated buffer / byte sink / file
# (reference: source/simple.cpp:231-363)
# --------------------------------------------------------------------------


def encode_into(
    dest: Union[np.ndarray, Callable[[int], None], PathLike],
    input_data: Union[BytesLike, Callable[[int], Pixel]],
    desc: Desc,
    *,
    overwrite: bool = False,
    backend: str = "auto",
    device=None,
):
    """Encode into a caller-owned destination.

    - numpy buffer  -> Result[EncodeStatus]: partial encode stops at a chunk
      boundary, never emitting a torn chunk (reference: simple.cpp:249-268).
      The device backend writes whole streams, so a buffer below the worst
      size takes the native partial encode, as the JAX package's api does;
      an explicit "torch" backend still raises first where there is no
      card.
    - byte-sink callable -> Result[int] (bytes emitted).
    - file path -> Result[int]; FILE_EXISTS unless overwrite, NOT_REGULAR_FILE,
      IO_ERROR (reference: simple.cpp:302-363).
    """
    from_gen = callable(input_data) and not isinstance(input_data, np.ndarray)

    if isinstance(dest, (str, os.PathLike)):
        path = Path(dest)
        if path.exists() and not overwrite:
            return Result.err(Error.FILE_EXISTS)
        if path.exists() and not path.is_file():
            return Result.err(Error.NOT_REGULAR_FILE)
        bc = count_bytes(desc)
        if not bc:
            return Result.err(bc.error())
        encoded = encode(input_data, desc, backend=backend, device=device)
        if not encoded:
            return Result.err(encoded.error())
        try:
            with open(path, "wb") as f:
                f.write(encoded.value().tobytes())
        except OSError:
            return Result.err(Error.IO_ERROR)
        return Result.ok(int(encoded.value().size))

    if callable(dest):
        # Byte-sink: encode fully, then feed the sink byte by byte
        # (reference: FuncByteWriter, source/util.hpp:262-269).
        if not from_gen:
            arr = _as_u8(input_data)
            if arr.size == 0:
                return Result.err(Error.EMPTY)
        bc = count_bytes(desc)
        if not bc:
            return Result.err(bc.error())
        if not from_gen and arr.size != bc.value():
            return Result.err(Error.MISMATCHED_DESC)
        encoded = encode(input_data, desc, backend=backend, device=device)
        if not encoded:
            return Result.err(encoded.error())
        for b in encoded.value().tobytes():
            dest(b)
        return Result.ok(int(encoded.value().size))

    # numpy output buffer
    out_buf = dest
    if not from_gen:
        arr = _as_u8(input_data)
        if arr.size == 0:
            return Result.err(Error.EMPTY)
    bc = count_bytes(desc)
    if not bc:
        return Result.err(bc.error())
    if from_gen:
        arr = _materialize_gen(input_data, desc)
    elif arr.size != bc.value():
        return Result.err(Error.MISMATCHED_DESC)

    ws = worst_size(desc).value()
    be = _resolve_backend(backend, desc.width * desc.height)
    if be == "torch":
        from .convert import resolve_device

        device = resolve_device(device)  # raises where there is no card
    # the device codec writes whole streams: a buffer below the worst size
    # takes the native partial encode (whole chunks up to its end), as the
    # JAX package's api does, once the device has been checked
    if be == "torch" and out_buf.size >= ws:
        data = _device_encode(arr, desc, device)
        out_buf[: data.size] = data
        return Result.ok(EncodeStatus(written=int(data.size), complete=True))

    out, complete = oracle.encode(arr, desc, out_cap=int(out_buf.size))
    out_buf[: out.size] = out
    return Result.ok(EncodeStatus(written=int(out.size), complete=complete))


# --------------------------------------------------------------------------
# decode — allocate-and-return (reference: source/simple.cpp:365-442)
# --------------------------------------------------------------------------


def decode(
    input_data: Union[BytesLike, PathLike],
    target: Optional[Channels] = None,
    flip_vertically: bool = False,
    *,
    backend: str = "auto",
    device=None,
) -> Result[Image]:
    """Decode a QOI byte buffer or file to a raw Image.

    Errors: EMPTY, TOO_SHORT (<= header+end marker), header errors
    (NOT_QOI/INVALID_DESC), TOO_BIG; file variants add FILE_NOT_EXISTS /
    NOT_REGULAR_FILE / IO_ERROR — reference: simple.cpp:365-441.
    """
    if isinstance(input_data, (str, os.PathLike)):
        path = Path(input_data)
        if not path.exists():
            return Result.err(Error.FILE_NOT_EXISTS)
        if not path.is_file():
            return Result.err(Error.NOT_REGULAR_FILE)
        try:
            data = path.read_bytes()
        except OSError:
            return Result.err(Error.IO_ERROR)
        return decode(data, target, flip_vertically, backend=backend,
                      device=device)

    arr = _as_u8(input_data)
    if arr.size == 0:
        return Result.err(Error.EMPTY)
    if arr.size <= HEADER_SIZE + END_MARKER_SIZE:
        return Result.err(Error.TOO_SHORT)

    header = read_header(arr)
    if not header:
        return Result.err(header.error())
    src_desc = header.value()
    dst_channels = target if target is not None else src_desc.channels
    out_desc = src_desc.replace(channels=dst_channels)

    bc = count_bytes(out_desc)
    if not bc:
        return Result.err(bc.error())

    be = _resolve_backend(backend, src_desc.width * src_desc.height)
    if be == "torch":
        data = _device_decode(arr, src_desc, dst_channels, device)
    else:
        data = oracle.decode(arr, src_desc, dst_channels)

    if flip_vertically:
        data = (
            data.reshape(out_desc.height, out_desc.width * int(dst_channels))[::-1]
            .reshape(-1)
            .copy()
        )
    return Result.ok(Image(data=data, desc=out_desc))


# --------------------------------------------------------------------------
# decode_into — preallocated buffer / pixel sink / file
# (reference: source/simple.cpp:444-568)
# --------------------------------------------------------------------------


def decode_into(
    dest: Union[np.ndarray, Callable[[Pixel], None]],
    input_data: Union[BytesLike, PathLike],
    target: Optional[Channels] = None,
    flip_vertically: bool = False,
    *,
    backend: str = "auto",
    device=None,
) -> Result[Desc]:
    """Decode into a caller-owned destination.

    - numpy buffer: NOT_ENOUGH_SPACE if smaller than the decoded byte count
      (reference: simple.cpp:470-471); returns the Desc with target channels.
    - pixel-sink callable: one call per decoded pixel (target/flip ignored,
      as in the reference — simple.cpp:513-527).
    """
    if isinstance(input_data, (str, os.PathLike)):
        path = Path(input_data)
        if not path.exists():
            return Result.err(Error.FILE_NOT_EXISTS)
        if not path.is_file():
            return Result.err(Error.NOT_REGULAR_FILE)
        try:
            data = path.read_bytes()
        except OSError:
            return Result.err(Error.IO_ERROR)
        return decode_into(dest, data, target, flip_vertically,
                           backend=backend, device=device)

    arr = _as_u8(input_data)
    if arr.size == 0:
        return Result.err(Error.EMPTY)
    if arr.size <= HEADER_SIZE + END_MARKER_SIZE:
        return Result.err(Error.TOO_SHORT)

    header = read_header(arr)
    if not header:
        return Result.err(header.error())
    src_desc = header.value()

    if callable(dest):
        # Pixel sink: emit every decoded RGBA pixel in order (reference:
        # FuncPixelWriter, source/util.hpp:281-296 — the per-pixel
        # virtual call).  Vectorized fast path: a sink that sets
        # ``dest.vectorized = True`` receives (N, 4) uint8 blocks (alpha
        # 0xFF for RGB sources) instead of one Pixel per call — opt-in
        # ONLY, because probing a sink by calling it would deliver
        # pixels as a side effect (unlike the generator probe).
        decoded = decode(arr, None, False, backend=backend,
                         device=device)
        if not decoded:
            return Result.err(decoded.error())
        img = decoded.value()
        ch = int(img.desc.channels)
        px = img.data.reshape(-1, ch)
        if getattr(dest, "vectorized", False) is True:
            if ch == 3:
                rgba = np.empty((px.shape[0], 4), np.uint8)
                rgba[:, :3] = px
                rgba[:, 3] = 0xFF
            else:
                rgba = px
            blk = 1 << 20
            for s in range(0, rgba.shape[0], blk):
                dest(rgba[s : s + blk])
            return Result.ok(src_desc)
        for i in range(px.shape[0]):
            if ch == 4:
                dest(Pixel(int(px[i, 0]), int(px[i, 1]), int(px[i, 2]), int(px[i, 3])))
            else:
                dest(Pixel(int(px[i, 0]), int(px[i, 1]), int(px[i, 2]), 0xFF))
        return Result.ok(src_desc)

    dst_channels = target if target is not None else src_desc.channels
    out_desc = src_desc.replace(channels=dst_channels)
    # Reference quirk: the space check uses the *source*-channel byte count —
    # `channels = dest` happens only after the check (simple.cpp:488-497).
    bc = count_bytes(src_desc)
    if not bc:
        return Result.err(bc.error())
    if dest.size < bc.value():
        return Result.err(Error.NOT_ENOUGH_SPACE)

    decoded = decode(arr, dst_channels, flip_vertically, backend=backend,
                     device=device)
    if not decoded:
        return Result.err(decoded.error())
    data = decoded.value().data
    n = min(int(dest.size), int(data.size))  # never overrun (reference would UB)
    dest[:n] = data[:n]
    return Result.ok(out_desc)
