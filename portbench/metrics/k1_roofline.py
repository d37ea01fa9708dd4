"""k1_roofline (%): K1 (replay_kernel, the chunk replay) against the
bound of the work the streams need (portbench/roofline.py: k1_replay)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "k1", "replay_kernel", exclude="<true>")
