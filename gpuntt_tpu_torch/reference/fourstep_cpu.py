"""Golden model of the 4-step NTT (CPU reference).

NumPy rebuild of `NTT_4STEP_CPU<T>` (ntt_4step_cpu.cu:10-299): the
4-step transform as explicit matrix operations — vector -> n1 x n2
matrix, transpose, n1-point column NTTs, W twiddle product, n2-point
row NTTs, transpose back — plus the special INTT input permutation
`vector_to_matrix_intt` (ntt_4step_cpu.cu:230-247) and its
`intt_first_transpose` helper (:289-299) that the device pipeline
expects callers to use.
"""

from __future__ import annotations

import numpy as np

from ..params.bitrev import bitrev_permute
from ..params.fourstep import NTTParameters4Step
from . import vecmod as vm


def _core_ntt_rows(mat, btable, q):
    """core_ntt (ntt_4step_cpu.cu:117-154) applied to each row of `mat`.

    Twiddle index is bitreverse(i, log_size - 1), i.e. slice [0:m] of the
    bit-reversed half-length table, for every reduction polynomial.
    """
    rows, size = mat.shape
    t = size
    m = 1
    out = mat
    while m < size:
        t >>= 1
        s = btable[0:m]
        v = out.reshape(rows, m, 2, t)
        u_part = v[:, :, 0, :]
        vmul = vm.vmulmod(v[:, :, 1, :], s[None, :, None], q)
        out = np.stack(
            [vm.vaddmod(u_part, vmul, q), vm.vsubmod(u_part, vmul, q)], axis=2
        ).reshape(rows, size)
        m <<= 1
    return out


def _core_intt_rows(mat, btable, q):
    """core_intt (ntt_4step_cpu.cu:156-196) applied to each row (no n^-1)."""
    rows, size = mat.shape
    t = 1
    m = size
    out = mat
    while m > 1:
        h = m >> 1
        s = btable[0:h]
        v = out.reshape(rows, h, 2, t)
        u_part = v[:, :, 0, :]
        v_part = v[:, :, 1, :]
        out = np.stack(
            [
                vm.vaddmod(u_part, v_part, q),
                vm.vmulmod(vm.vsubmod(u_part, v_part, q), s[None, :, None], q),
            ],
            axis=2,
        ).reshape(rows, size)
        t <<= 1
        m = h
    return out


def intt_input_indices(n1: int, n2: int) -> np.ndarray:
    """Closed form of vector_to_matrix_intt (ntt_4step_cpu.cu:230-247).

    Element k of the flattened permuted buffer reads input index
    (k // n2) + (k % n2) * n1; the buffer is then treated as an
    (n2, n1) matrix.
    """
    k = np.arange(n1 * n2)
    return (k // n2) + (k % n2) * n1


class NTT4StepCPU:
    """Golden 4-step model (ntt_4step_cpu.cu:33-111)."""

    def __init__(self, parameters: NTTParameters4Step):
        self.p = parameters

    def mult(self, a, b) -> np.ndarray:
        q = self.p.modulus.value
        return vm.from_work_array(
            vm.vmulmod(vm.to_work_array(a, q), vm.to_work_array(b, q), q),
            self.p.dtype,
        )

    def ntt(self, x) -> np.ndarray:
        """Forward 4-step NTT (ntt_4step_cpu.cu:33-68)."""
        p = self.p
        q = p.modulus.value
        if p.dtype == np.uint64:
            from .. import _native

            if _native.available():
                mat = np.asarray(x, dtype=np.uint64).reshape(p.n1, p.n2)
                t = np.ascontiguousarray(mat.T)
                t = _native.core_ntt_rows(t, p.n1_based_root_of_unity_table, q)
                vec = np.ascontiguousarray(t.T).reshape(-1)
                vec = _native.pointwise_mult(vec, p.W_root_of_unity_table, q)
                mat3 = _native.core_ntt_rows(vec.reshape(p.n1, p.n2),
                                             p.n2_based_root_of_unity_table, q)
                return np.ascontiguousarray(mat3.T).reshape(-1)
        w = vm.to_work_array(x, q)
        bt_n1 = vm.to_work_array(bitrev_permute(p.n1_based_root_of_unity_table), q)
        bt_n2 = vm.to_work_array(bitrev_permute(p.n2_based_root_of_unity_table), q)
        w_tab = vm.to_work_array(p.W_root_of_unity_table, q)

        mat = w.reshape(p.n1, p.n2)  # vector_to_matrix
        t = mat.T.copy()  # (n2, n1)
        t = _core_ntt_rows(t, bt_n1, q)  # n1-point NTT per column of mat
        vec = t.T.reshape(-1)  # transpose back + flatten
        vec = vm.vmulmod(vec, w_tab, q)  # W product (ntt_4step_cpu.cu:200-210)
        mat3 = vec.reshape(p.n1, p.n2)
        mat3 = _core_ntt_rows(mat3, bt_n2, q)  # n2-point NTT per row
        result = mat3.T.reshape(-1)  # final transpose + flatten
        return vm.from_work_array(result, p.dtype)

    def intt(self, x) -> np.ndarray:
        """Inverse 4-step NTT (ntt_4step_cpu.cu:70-111)."""
        p = self.p
        q = p.modulus.value
        if p.dtype == np.uint64:
            from .. import _native

            if _native.available():
                xx = np.asarray(x, dtype=np.uint64)
                buf = xx[intt_input_indices(p.n1, p.n2)].reshape(p.n2, p.n1)
                buf = _native.core_intt_rows(
                    buf, p.n1_based_inverse_root_of_unity_table, q
                )
                vec = np.ascontiguousarray(buf.T).reshape(-1)
                vec = _native.pointwise_mult(
                    vec, p.W_inverse_root_of_unity_table, q
                )
                mat3 = _native.core_intt_rows(
                    vec.reshape(p.n1, p.n2), p.n2_based_inverse_root_of_unity_table, q
                )
                res = np.ascontiguousarray(mat3.T).reshape(-1)
                n_inv_arr = np.full(p.n, p.n_inv, dtype=np.uint64)
                return _native.pointwise_mult(res, n_inv_arr, q)
        w = vm.to_work_array(x, q)
        bt_n1 = vm.to_work_array(
            bitrev_permute(p.n1_based_inverse_root_of_unity_table), q
        )
        bt_n2 = vm.to_work_array(
            bitrev_permute(p.n2_based_inverse_root_of_unity_table), q
        )
        w_tab = vm.to_work_array(p.W_inverse_root_of_unity_table, q)

        buf = w[intt_input_indices(p.n1, p.n2)].reshape(p.n2, p.n1)
        buf = _core_intt_rows(buf, bt_n1, q)
        vec = buf.T.reshape(-1)  # transpose (n2,n1)->(n1,n2) + flatten
        vec = vm.vmulmod(vec, w_tab, q)
        mat3 = vec.reshape(p.n1, p.n2)
        mat3 = _core_intt_rows(mat3, bt_n2, q)
        result = mat3.T.reshape(-1)
        result = vm.vmulmod(result, p.n_inv, q)
        return vm.from_work_array(result, p.dtype)

    def intt_first_transpose(self, x) -> np.ndarray:
        """Caller-side INTT pre-permutation (ntt_4step_cpu.cu:289-299)."""
        x = np.asarray(x)
        return x[intt_input_indices(self.p.n1, self.p.n2)]
