"""encode_mpix_s (MPix/s): every pixel encoded, its stream delivered to
the host, in the window, over the window's time."""

from portbench.readers import mpix_s


def read(rec):
    return mpix_s(rec, "encode")
