"""rounds_per_window.stream_decode (rounds): the program's counter
``stream_rounds`` (each window's seam fixpoint rounds) over its counter
``stream_windows`` (windows decoded), over the window's calls."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    rounds = program.counter(p, "stream_rounds")
    windows = program.counter(p, "stream_windows")
    return None if rounds is None or not windows else rounds / windows
