"""e1_roofline.stream_encode (%): E1 (fields_kernel and its
fields_summary_kernel launch, each window's fields from the carried
state) against the bound of the image's pixels read and template words
written (roofline.e1_fields)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "e1", "fields_kernel", "fields_summary_kernel")
