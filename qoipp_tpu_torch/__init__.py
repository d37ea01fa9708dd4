"""qoipp_tpu_torch — the QOI batch codec in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The port of ``qoipp_tpu``: the same module names, the same public shapes,
bit-exact output.  Its host layer (``common``: ``Desc``, ``Channels``,
headers; ``oracle``: the native reference codec) is its own copy; this
package imports ``torch`` and never ``jax`` or ``qoipp_tpu``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.

Pixel words travel as ``torch.int32`` tensors holding the uint32 bit
pattern ``r | g<<8 | b<<16 | a<<24`` (torch lacks most uint32 arithmetic);
``qoipp_tpu_torch.convert`` moves words and replay carries to and from the
uint32 numpy arrays the JAX package uses.
"""

from .common import (
    END_MARKER,
    END_MARKER_SIZE,
    HEADER_SIZE,
    MAGIC,
    Channels,
    Colorspace,
    Desc,
    Error,
    Result,
    count_bytes,
    is_valid,
    read_header,
    worst_size,
    write_header,
)

__version__ = "0.1.0"


def __getattr__(name):
    # the device codecs pull in the kernels' modules; load them on first use
    if name == "BatchPipeline":
        from .models.pipeline import BatchPipeline

        return BatchPipeline
    if name == "DeviceStreamDecoder":
        from .ops.device_stream import DeviceStreamDecoder

        return DeviceStreamDecoder
    if name == "DeviceStreamEncoder":
        from .ops.device_stream import DeviceStreamEncoder

        return DeviceStreamEncoder
    raise AttributeError(name)


__all__ = [
    "BatchPipeline",
    "Channels",
    "Colorspace",
    "Desc",
    "DeviceStreamDecoder",
    "DeviceStreamEncoder",
    "END_MARKER",
    "END_MARKER_SIZE",
    "Error",
    "HEADER_SIZE",
    "MAGIC",
    "Result",
    "count_bytes",
    "is_valid",
    "read_header",
    "worst_size",
    "write_header",
]
