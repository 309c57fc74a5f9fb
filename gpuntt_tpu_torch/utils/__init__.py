"""Measurement utilities."""

from .timing import time_cuda

__all__ = ["time_cuda"]
