"""Kernel timing on the card with CUDA events.

`time_cuda` warms a callable up, then times `repeats` windows of
`inner` back-to-back calls, each window between two CUDA events on the
current stream, and returns the median milliseconds per call with the
(max - min) / median spread over the windows.  Events time the
device's work, so the host's enqueue cost does not enter, and a window
of several calls keeps one slow call from setting the spread.  There is
no CPU fallback: a measurement path that finds no card fails.
"""

from __future__ import annotations

import torch


def time_cuda(fn, warmup: int = 3, repeats: int = 10,
              inner: int = 10) -> tuple[float, float]:
    """(median ms per call, (max - min) / median) of `fn()` on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    times.sort()
    med = times[len(times) // 2]
    return med, (times[-1] - times[0]) / med
