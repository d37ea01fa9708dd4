"""host_wait_ms.stream_encode (ms): host time a call of the window blocked
on the device, in the program's spans ``host.fetch`` (each window's bytes,
from the masked_select that sizes them to the numpy array) and
``host.sync`` (every blocking read of a device flag)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "encode":
        return None
    return program.span_ms(p, "host.fetch", "host.sync")
