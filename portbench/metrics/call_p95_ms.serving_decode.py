"""call_p95_ms.serving_decode (ms): call_p95_ms in serving_corpus_decode,
read in the traced run: the whole call as its caller waits on it, over
every call of the window (the traced calls come after it).  Per-layer
there: between runs of one seed it spreads 10-17%, too wide for an
end-to-end bound."""

from portbench.readers import p95_ms as read  # noqa: F401
