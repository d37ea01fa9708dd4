"""host_wait_ms.serving_encode (ms): host time a call of the window blocked
on the device, in the program's spans ``host.fetch`` (every D2H copy) and
``host.sync`` (every blocking read of a device flag)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "encode":
        return None
    return program.span_ms(p, "host.fetch", "host.sync")
