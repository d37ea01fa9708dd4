"""host_plan_ms.stream_decode (ms): host time a call of the window in the
program's spans ``host.plan`` (DeviceStreamDecoder.plan_window: the native
walker's cuts of each window and the copy of its segments into lane
regions)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    return program.span_ms(p, "host.plan")
