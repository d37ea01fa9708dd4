"""host_stage_ms.serving_encode (ms): host-clock time a call in
ServingCodec.encode_stage (the router, the planners and the uploads)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "encode_stage")
