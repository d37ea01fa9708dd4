"""template_rows_per_px.encode (rows/px): the program's counter
``template_rows`` (the rows the template and offset passes run over) over
the pixels encoded in the window's calls."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "encode":
        return None
    v = program.counter(p, "template_rows")
    return None if v is None or not p.pixels else v / p.pixels
