"""k5_roofline.stream_decode (%): K5 (replay_kernel, every fixpoint round
of every window) against the bound of one replay of the stream's real
chunks, 12 bytes and 24 operations a chunk (kinds/stream_decode.py): the
rounds past the first are work the bound does not count."""

from portbench.roofline import share


def read(rec):
    return share(rec, "k5", "replay_kernel")
