"""Golden model of the merged NTT (CPU reference).

NumPy rebuild of the reference's `NTTCPU<T>` (ntt_cpu.cu:62-185):
iterative in-place merged Cooley-Tukey NTT (decimation-in-time, no
pre-bit-reversal; twiddle index = bitreverse(group) — eprint 2016/504
style), Gentleman-Sande INTT with final n^-1 scaling, and pointwise
mult.  Output order matches the reference element-for-element; this is
the parity oracle for every TPU engine test.
"""

from __future__ import annotations

import numpy as np

from ..arith import host
from ..params.bitrev import bitrev_permute
from ..params.merge import NTTParameters, ReductionPolynomial
from . import vecmod as vm


class NTTCPU:
    """Golden merged-NTT model (ntt_cpu.cu:62-185)."""

    def __init__(self, parameters: NTTParameters):
        self.p = parameters

    # -- pointwise multiply (ntt_cpu.cu:67-79) --
    def mult(self, a, b) -> np.ndarray:
        q = self.p.modulus.value
        if self.p.dtype == np.uint64:
            from .. import _native

            if _native.available():
                return _native.pointwise_mult(
                    np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64), q
                )
        wa = vm.to_work_array(a, q)
        wb = vm.to_work_array(b, q)
        return vm.from_work_array(vm.vmulmod(wa, wb, q), self.p.dtype)

    def ntt(self, x) -> np.ndarray:
        """Forward merged NTT (ntt_cpu.cu:81-128).

        Stage with m groups multiplies V by S[i] = table[bitreverse(i,
        logn-1)] (X_N_minus) or table[bitreverse(m+i, logn)] (X_N_plus);
        with the bit-reversed table those are the slices [0:m] / [m:2m].
        64-bit inputs route to the native __int128 core when available
        (a third independent implementation; cross-checked against the
        Python path in tests).
        """
        p = self.p
        q = p.modulus.value
        if p.dtype == np.uint64:
            from .. import _native

            if _native.available():
                xnp = p.poly_reduction == ReductionPolynomial.X_N_plus
                return _native.ntt_merge(
                    np.asarray(x, dtype=np.uint64),
                    p.logn,
                    p.forward_root_of_unity_table,
                    q,
                    xnp,
                )
        out = vm.to_work_array(x, q)
        assert out.shape[-1] == p.n
        btable = vm.to_work_array(bitrev_permute(p.forward_root_of_unity_table), q)
        xnp = p.poly_reduction == ReductionPolynomial.X_N_plus

        t = p.n
        m = 1
        lead = out.shape[:-1]
        while m < p.n:
            t >>= 1
            s = btable[m : 2 * m] if xnp else btable[0:m]
            v = out.reshape(lead + (m, 2, t))
            u_part = v[..., 0, :]
            vmul = vm.vmulmod(v[..., 1, :], s[:, None], q)
            new = np.stack(
                [vm.vaddmod(u_part, vmul, q), vm.vsubmod(u_part, vmul, q)],
                axis=-2,
            )
            out = new.reshape(lead + (p.n,))
            m <<= 1
        return vm.from_work_array(out, p.dtype)

    def intt(self, x) -> np.ndarray:
        """Inverse merged NTT + n^-1 scaling (ntt_cpu.cu:130-185)."""
        p = self.p
        q = p.modulus.value
        if p.dtype == np.uint64:
            from .. import _native

            if _native.available():
                xnp = p.poly_reduction == ReductionPolynomial.X_N_plus
                return _native.intt_merge(
                    np.asarray(x, dtype=np.uint64),
                    p.logn,
                    p.inverse_root_of_unity_table,
                    q,
                    xnp,
                )
        out = vm.to_work_array(x, q)
        btable = vm.to_work_array(bitrev_permute(p.inverse_root_of_unity_table), q)
        xnp = p.poly_reduction == ReductionPolynomial.X_N_plus

        t = 1
        m = p.n
        lead = out.shape[:-1]
        while m > 1:
            h = m >> 1
            s = btable[h : 2 * h] if xnp else btable[0:h]
            v = out.reshape(lead + (h, 2, t))
            u_part = v[..., 0, :]
            v_part = v[..., 1, :]
            new = np.stack(
                [
                    vm.vaddmod(u_part, v_part, q),
                    vm.vmulmod(vm.vsubmod(u_part, v_part, q), s[:, None], q),
                ],
                axis=-2,
            )
            out = new.reshape(lead + (p.n,))
            t <<= 1
            m = h

        n_inv = host.modinv(p.n, p.modulus)  # recomputed as in ntt_cpu.cu:177
        out = vm.vmulmod(out, n_inv, q)
        return vm.from_work_array(out, p.dtype)
