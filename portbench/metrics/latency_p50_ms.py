"""latency_p50_ms: median over every call of the window of a synchronous
call's time, between CUDA events recorded before the call and after it."""

from portbench.metrics_lib import latency_percentile


def read(rec):
    return latency_percentile(rec, 50)
