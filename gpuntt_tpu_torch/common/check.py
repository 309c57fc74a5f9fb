"""Result comparison helper.

TPU-native equivalent of the reference's `check_result<T>`
(src/lib/common/common.cu:24-42, instantiated for u32/u64/i32/i64 at
common.cu:44-54): element-wise equality with the index of the first
mismatch reported, used by every example/test binary.
"""

from __future__ import annotations

import numpy as np


def check_result(a, b, verbose: bool = True) -> bool:
    """True iff arrays are element-wise identical.

    Prints the first mismatching index like the reference does
    (common.cu:29-35) when `verbose`.
    """
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        if verbose:
            print(f"Shape mismatch: {a.shape} vs {b.shape}")
        return False
    neq = a != b
    if neq.any():
        idx = int(np.argmax(neq))
        if verbose:
            print(f"Mismatch at index {idx}: {a[idx]} != {b[idx]}")
        return False
    return True
