"""torch_passes_ms.stream_encode (ms): device time a traced call of every
kernel that is neither one of the program's own nor a copy or fill: the
streaming encoder's torch passes (packing, masks, offsets, the fetch's
masked_select)."""

from portbench.readers import torch_passes_ms


def read(rec):
    return torch_passes_ms(rec, "encode")
