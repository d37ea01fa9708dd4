"""k2_roofline (%): K2 (place_fill_kernel, placement and run fill)
against the bound of the pixels placed (roofline.k2_place)."""

from portbench.roofline import share


def read(rec):
    return share(rec, "k2", "place_fill_kernel")
