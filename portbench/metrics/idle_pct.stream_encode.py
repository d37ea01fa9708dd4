"""idle_pct.stream_encode (%): share of the traced window's wall time
(first traced call's start to the last one's end) with no kernel, copy or
fill running on the device, in the streaming encode cell."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec, "encode")
