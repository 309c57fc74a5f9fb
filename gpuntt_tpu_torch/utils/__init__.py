"""Measurement, profiling and the work model."""

from .profiling import NTTCost, measure_modmul_peak, ntt_cost, trace
from .timing import time_cuda

__all__ = ["NTTCost", "measure_modmul_peak", "ntt_cost", "trace", "time_cuda"]
