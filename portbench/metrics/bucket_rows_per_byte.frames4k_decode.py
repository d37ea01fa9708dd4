"""bucket_rows_per_byte.frames4k_decode (rows/B): the program's counter
``bucket_rows`` (the region bytes the length buckets replay, padded lanes
x each bucket's qb) over its counter ``bucket_stream_bytes`` (the real
streams' bytes), over the window's calls: 1 would be no padding at all."""

from portbench import program


def read(rec):
    p = rec.program
    if p is None or p.direction != "decode":
        return None
    rows = program.counter(p, "bucket_rows")
    stream = program.counter(p, "bucket_stream_bytes")
    return None if rows is None or not stream else rows / stream
