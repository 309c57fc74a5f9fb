"""Arithmetic that several metric readers share, and the card's peak."""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def latency_percentile(rec: dict, q: float):
    lat = rec.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=np.float64), q))


def idle_share(rec: dict):
    """100 * (1 - busy / window) of the traced window."""
    t = rec.get("trace")
    if not t or not t["window_s"] or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
