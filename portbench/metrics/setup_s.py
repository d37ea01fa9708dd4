"""setup_s (s): process start to the first timed call: imports, the
kernel library (built only by the first run in a checkout), inputs from
the seed, the program's objects and the warm-up calls."""


def read(rec):
    return rec.setup_s
