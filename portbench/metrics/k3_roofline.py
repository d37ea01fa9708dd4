"""k3_roofline (%): K3 (compact_kernel) against the bound of the rows
scanned and kept (roofline.k3_compact)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "k3", "compact_kernel")
