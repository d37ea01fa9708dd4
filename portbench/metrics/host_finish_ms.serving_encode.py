"""host_finish_ms.serving_encode (ms): host-clock time a call in
ServingCodec.encode_finish (the fetch and the host unpack or reassembly)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "encode_finish")
