"""k4_roofline (%): K4 (emit_kernel) against the bound of the stream
bytes written (roofline.k4_emit)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "k4", "emit_kernel")
