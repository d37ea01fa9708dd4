"""e1_roofline (%): E1 (fields_kernel and its fields_summary_kernel
launch, the batch encoder's first stage) against the bound of the pixels
it reads and the template words it writes (roofline.e1_fields)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "e1", "fields_kernel", "fields_summary_kernel")
