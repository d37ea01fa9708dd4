"""host_finish_ms.serving_decode (ms): host-clock time a call in
ServingCodec.decode_finish (the fetch and the host unpack or reassembly)."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "decode_finish")
