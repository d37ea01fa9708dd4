"""templates_device_ms.encode (ms): device time a traced call of the
kernels launched inside the program's span ``encode.templates`` (the
batch encoder's offsets, the lane encoder's template passes)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "encode":
        return None
    return program.device_ms_in(p, "encode.templates")
