"""Bit-reversal utilities (reference: nttparameters.cu:10-20)."""

from __future__ import annotations

import numpy as np


def bitreverse(index: int, n_power: int) -> int:
    """Reverse the low `n_power` bits of `index` (nttparameters.cu:10-20)."""
    res = 0
    for _ in range(n_power):
        res = (res << 1) | (index & 1)
        index >>= 1
    return res


def bitreverse_indices(n_power: int) -> np.ndarray:
    """Vector of bitreverse(i, n_power) for i in [0, 2^n_power).

    O(N) doubling construction instead of the per-index loop — identical
    values, used to permute whole tables at once.
    """
    n = 1 << n_power
    idx = np.zeros(n, dtype=np.int64)
    half = 1
    shift = n_power - 1
    while half < n:
        idx[half : 2 * half] = idx[:half] + (1 << shift)
        half <<= 1
        shift -= 1
    return idx


def bitrev_permute(table: np.ndarray) -> np.ndarray:
    """Permute `table` into bit-reversed order.

    Equivalent of gpu_root_of_unity_table_generator
    (nttparameters.cu:175-189 and :456-471): new[i] = table[bitreverse(i, lg)]
    with lg = log2(len(table)).
    """
    n = len(table)
    lg = n.bit_length() - 1
    assert (1 << lg) == n, "table length must be a power of two"
    return np.asarray(table)[bitreverse_indices(lg)]
