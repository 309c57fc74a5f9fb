"""Vectorized exact modular arithmetic for the golden models.

For q < 2^31 (Data32 pools) int64 intermediates are exact (products
< 2^60).  For larger q (Data64 pools, up to 62 bits) NumPy cannot hold
the 124-bit products, so we fall back to object-dtype arrays of Python
ints — slower but exact, which is what a golden model must be.
"""

from __future__ import annotations

import numpy as np


def to_work_array(x, q: int) -> np.ndarray:
    """Lift input into an exact-arithmetic working array."""
    x = np.asarray(x)
    if q < (1 << 31):
        return x.astype(np.int64)
    return np.array([int(v) for v in x.ravel()], dtype=object).reshape(x.shape)


def from_work_array(x: np.ndarray, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    if x.dtype == object:
        flat = np.fromiter((int(v) for v in x.ravel()), dtype=dt, count=x.size)
        return flat.reshape(x.shape)
    return x.astype(dt)


def vmulmod(a, b, q: int):
    return (a * b) % q


def vaddmod(a, b, q: int):
    return (a + b) % q


def vsubmod(a, b, q: int):
    return (a - b) % q
