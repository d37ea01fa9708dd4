"""boundary_device_ms.decode (ms): device time a traced call of the
kernels launched inside the program's span ``decode.boundary``
(ops/boundary.analyze_region_batch: the boundary pass's torch kernels)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    return program.device_ms_in(p, "decode.boundary")
