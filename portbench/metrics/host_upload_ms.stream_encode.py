"""host_upload_ms.stream_encode (ms): host time a call of the window in the
program's spans ``host.upload`` (DeviceStreamEncoder.encode_window's
pageable copy of each window's raw pixels to the device)."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "encode":
        return None
    return program.span_ms(p, "host.upload")
