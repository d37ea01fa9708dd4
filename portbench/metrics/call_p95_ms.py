"""call_p95_ms (ms): the 95th percentile of the latency of every call of
the window (linear interpolation between order statistics)."""

from portbench.readers import p95_ms as read  # noqa: F401
