"""d2h_bytes_per_px.serving_decode (B/px): the program's counter
``d2h_bytes`` (bytes fetched from the device) over the pixels decoded in
the window's calls."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    v = program.counter(p, "d2h_bytes")
    return None if v is None or not p.pixels else v / p.pixels
