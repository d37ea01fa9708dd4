"""qoipp_tpu_torch — the QOI batch codec in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The port of ``qoipp_tpu``: the same module names, the same public names,
bit-exact output.  Its host layer (``common``, ``oracle``: the native
reference codec, ``api``: the one-shot overloads, ``stream``: the host
streaming codec) is its own copy; this package imports ``torch`` and never
``jax`` or ``qoipp_tpu``.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.

Pixel words travel as ``torch.int32`` tensors holding the uint32 bit
pattern ``r | g<<8 | b<<16 | a<<24`` (torch lacks most uint32 arithmetic);
``qoipp_tpu_torch.convert`` moves words and replay carries to and from the
uint32 numpy arrays the JAX package uses.
"""

from .common import (
    BIAS_OP_DIFF,
    BIAS_OP_LUMA_G,
    BIAS_OP_LUMA_RB,
    BIAS_OP_RUN,
    END_MARKER,
    END_MARKER_SIZE,
    HEADER_SIZE,
    MAGIC,
    RUN_LIMIT,
    RUNNING_ARRAY_SIZE,
    Channels,
    Colorspace,
    Desc,
    EncodeStatus,
    Error,
    Image,
    Pixel,
    Result,
    StreamResult,
    count_bytes,
    is_valid,
    make_error,
    make_result,
    read_header,
    to_channels,
    to_colorspace,
    to_string,
    worst_size,
    write_header,
)

__version__ = "0.1.0"

# the one-shot API and the host streaming codec load no kernel module until
# a device backend is asked for
from .api import decode, decode_into, encode, encode_into  # noqa: E402
from .stream import StreamDecoder, StreamEncoder  # noqa: E402

# the device codecs pull in the kernels' modules: loaded on first use
_LAZY = {
    "BatchPipeline": "models.pipeline",
    "BucketedCodec": "models.scheduler",
    "DeviceStreamDecoder": "ops.device_stream",
    "DeviceStreamEncoder": "ops.device_stream",
    "PackedDecoder": "models.packed",
    "PackedEncoder": "models.packed",
    "ResidentCorpus": "models.serving",
    "ServingCodec": "models.serving",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)


__all__ = [
    "BatchPipeline",
    "BucketedCodec",
    "DeviceStreamDecoder",
    "DeviceStreamEncoder",
    "PackedDecoder",
    "PackedEncoder",
    "ResidentCorpus",
    "ServingCodec",
    "Channels",
    "Colorspace",
    "Desc",
    "EncodeStatus",
    "Error",
    "Image",
    "Pixel",
    "Result",
    "StreamResult",
    "StreamEncoder",
    "StreamDecoder",
    "BIAS_OP_DIFF",
    "BIAS_OP_LUMA_G",
    "BIAS_OP_LUMA_RB",
    "BIAS_OP_RUN",
    "END_MARKER",
    "END_MARKER_SIZE",
    "HEADER_SIZE",
    "MAGIC",
    "RUN_LIMIT",
    "RUNNING_ARRAY_SIZE",
    "count_bytes",
    "decode",
    "decode_into",
    "encode",
    "encode_into",
    "is_valid",
    "make_error",
    "make_result",
    "read_header",
    "to_channels",
    "to_colorspace",
    "to_string",
    "worst_size",
    "write_header",
]
