"""host_stage_ms.serving_decode (ms): host-clock time a call in
ServingCodec.decode_stage (the router, the planners and the uploads)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "decode_stage")
