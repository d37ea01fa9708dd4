"""launches_per_call.decode (launches): device launches a traced call of the
decode torch passes (kernels neither the program's own nor copies or
fills)."""

from portbench.readers import launches_per_call


def read(rec):
    return launches_per_call(rec, "decode")
