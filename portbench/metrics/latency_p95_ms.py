"""latency_p95_ms: 95th percentile over every call of the window of a
synchronous call's time, between CUDA events before and after it."""

from portbench.metrics_lib import latency_percentile


def read(rec):
    return latency_percentile(rec, 95)
