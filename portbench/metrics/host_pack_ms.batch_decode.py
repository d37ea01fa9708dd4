"""host_pack_ms.batch_decode (ms): host time a call of the window in the
program's span ``host.pack_streams`` (BatchPipeline.pack_streams: the
host streams copied into one padded array)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    return program.span_ms(p, "host.pack_streams")
