"""host_unpack_ms.serving_decode (ms): self time a call of the window in
the program's spans ``host.unpack`` (the host's cut and reassembly of the
fetched pixels), less the fetches and syncs inside them."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    return program.self_ms(p, "host.unpack")
