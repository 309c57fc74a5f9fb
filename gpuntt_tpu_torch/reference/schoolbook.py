"""Schoolbook polynomial multiplication golden model.

NumPy rebuild of `schoolbook_poly_multiplication` (ntt_cpu.cu:10-52):
O(N^2) product of two degree-(N-1) polynomials followed by folding
modulo X^N - 1 (add wrap) or X^N + 1 (subtract wrap).
"""

from __future__ import annotations

import numpy as np

from ..arith.modulus import Modulus
from ..params.merge import ReductionPolynomial
from . import vecmod as vm


def schoolbook_poly_multiplication(
    a, b, modulus: Modulus, reduction_poly: ReductionPolynomial
) -> np.ndarray:
    a = np.asarray(a)
    dtype = a.dtype
    q = modulus.value
    wa = vm.to_work_array(a, q)
    wb = vm.to_work_array(b, q)
    n = wa.shape[0]
    full = np.zeros(2 * n, dtype=wa.dtype)
    for i in range(n):
        full[i : i + n] = (full[i : i + n] + wa[i] * wb) % q
    if reduction_poly == ReductionPolynomial.X_N_minus:
        res = (full[:n] + full[n:]) % q
    else:
        res = (full[:n] - full[n:]) % q
    return vm.from_work_array(res, dtype)
