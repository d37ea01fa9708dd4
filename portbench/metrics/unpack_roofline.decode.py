"""unpack_roofline.decode (%): the batch decode's last pass (the program's
span ``decode.unpack``: packed int32 pixel words to C-byte pixels) against
the bound of the bytes it must move, each word read (4 bytes a pixel,
counter ``unpack_px``) and each pixel byte written (``unpack_bytes``), at
the card's HBM peak, over the device time a traced call of the kernels
launched inside the span.  The counters count the lanes the pass really
unpacks, padded ones included."""

from portbench import program
from portbench.roofline import PEAKS


def read(rec):
    p = rec.program
    peaks = PEAKS.get(rec.device_kind)
    if p is None or p.direction != "decode" or peaks is None or not p.calls:
        return None
    px = program.counter(p, "unpack_px")
    nbytes = program.counter(p, "unpack_bytes")
    ms = program.device_ms_in(p, "decode.unpack")
    if px is None or nbytes is None or not ms:
        return None
    bound_s = (4 * px + nbytes) / p.calls / peaks[0]
    return 100.0 * bound_s / (ms * 1e-3)
