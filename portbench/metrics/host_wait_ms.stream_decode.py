"""host_wait_ms.stream_decode (ms): host time a call of the window blocked
on the device, in the program's spans ``host.fetch`` (each window's pixels,
from the masked_select that sizes them to the numpy array) and
``host.sync`` (each fixpoint round's blocking flag read)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    return program.span_ms(p, "host.fetch", "host.sync")
