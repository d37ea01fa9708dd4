"""pack_roofline.encode (%): the batch encoder's first pass (the program's
span ``encode.pack``, ``BatchPipeline.raw_to_packed``: C-byte pixels to
packed int32 words, padded to the tile) against the bound of the bytes it
must move, each raw byte read (counter ``pack_bytes``, C a pixel) and each
word written (4 bytes a pixel, ``pack_px``), at the card's HBM peak, over
the device time a traced call of the kernels launched inside the span."""

from portbench import program
from portbench.roofline import PEAKS


def read(rec):
    p = rec.program
    peaks = PEAKS.get(rec.device_kind)
    if p is None or p.direction != "encode" or peaks is None or not p.calls:
        return None
    px = program.counter(p, "pack_px")
    nbytes = program.counter(p, "pack_bytes")
    ms = program.device_ms_in(p, "encode.pack")
    if px is None or nbytes is None or not ms:
        return None
    bound_s = (nbytes + 4 * px) / p.calls / peaks[0]
    return 100.0 * bound_s / (ms * 1e-3)
