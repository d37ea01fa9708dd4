"""launches_per_call.encode (launches): device launches a traced call of the
encode torch passes (kernels neither the program's own nor copies or
fills)."""

from portbench.readers import launches_per_call


def read(rec):
    return launches_per_call(rec, "encode")
