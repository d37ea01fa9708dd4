"""split_rounds_per_call.serving_decode (rounds): the program's counter
``split_rounds`` (the split route's seam fixpoint rounds) a call of the
window."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    v = program.counter(p, "split_rounds")
    return None if v is None or not p.calls else v / p.calls
