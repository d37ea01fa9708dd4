"""idle_pct.stream_decode (%): share of the traced window's wall time
(first traced call's start to the last one's end) with no kernel, copy or
fill running on the device, in the streaming decode cell."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "decode")
