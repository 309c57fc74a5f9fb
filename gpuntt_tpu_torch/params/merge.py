"""NTT parameters for the merged radix-2 NTT.

Rebuild of the reference's `NTTParameters<T>` (nttparameters.cuh:56-104,
nttparameters.cu:22-189): same hardcoded prime pools, omega/psi base
values, exponent scaling, sequential power tables, Fermat n^-1, and the
bit-reversed device table permutation — produced as NumPy arrays instead
of device vectors.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from ..arith import host
from ..arith.modulus import Modulus, Modulus32, Modulus64
from ..common.errors import custom_assert
from .bitrev import bitrev_permute


class ReductionPolynomial(enum.Enum):
    """Reduction polynomial selector (nttparameters.cuh:30-36)."""

    X_N_minus = 0  # X^N - 1 (cyclic)
    X_N_plus = 1  # X^N + 1 (negacyclic)


class NTTType(enum.Enum):
    """Transform direction (nttparameters.cuh:19-23)."""

    FORWARD = 0
    INVERSE = 1


class NTTLayout(enum.Enum):
    """Batch layout (nttparameters.cuh:25-28).

    PerPolynomial: each row of the (batch, N) buffer is one polynomial.
    PerCoefficient: the transform runs across the batch axis at fixed
    coefficient index (columns of the same buffer) — on TPU this is just
    an axis choice, not a different kernel family (cf. ntt.cu:1554-2075).
    """

    PerPolynomial = 0
    PerCoefficient = 1


@dataclass(frozen=True)
class NTTFactors:
    """User-provided (modulus, omega, psi) triple (nttparameters.cuh:38-54)."""

    modulus: Modulus
    omega: int
    psi: int


def _dtype_bits(dtype) -> int:
    dt = np.dtype(dtype)
    if dt == np.uint32:
        return 32
    if dt == np.uint64:
        return 64
    raise ValueError(f"dtype must be uint32 or uint64, got {dt}")


def _power_table(base: int, q: int, size: int):
    """[base^0, base^1, ..., base^(size-1)] mod q.

    Same values as the sequential Barrett loop (nttparameters.cu:144-168).
    Uses the native core when available; exact-Python fallback otherwise.
    The native core's Shoup mulmod needs 2q < 2^64, so caller-supplied
    moduli q >= 2^63 (beyond the reference's documented 62-bit Barrett
    range, modular_arith.cuh:66-67) take the exact-Python path.
    """
    from .. import _native

    if size >= 1 << 10 and q < 1 << 63 and _native.available():
        return _native.power_table(base % q, q, size)
    out = [1] * size
    acc = 1
    for i in range(1, size):
        acc = (acc * base) % q
        out[i] = acc
    return out


class NTTParameters:
    """Parameters + twiddle tables for a 2^logn-point merged NTT.

    Reference: NTTParameters<T> ctor (nttparameters.cu:22-49).
    `dtype` selects the Data32 (uint32) or Data64 (uint64) pools.
    """

    def __init__(
        self,
        logn: int,
        poly_reduction: ReductionPolynomial = ReductionPolynomial.X_N_minus,
        dtype=np.uint64,
        factors: NTTFactors | None = None,
    ):
        self.logn = int(logn)
        self.n = 1 << self.logn
        self.poly_reduction = poly_reduction
        self.dtype = np.dtype(dtype)
        bits = _dtype_bits(dtype)

        if factors is None:
            self.modulus = self._modulus_pool(bits)
            self.omega = self._omega_pool(bits)
            self.psi = self._psi_pool(bits)
        else:
            self.modulus = factors.modulus
            self.omega = factors.omega
            self.psi = factors.psi

        # root selection (nttparameters.cu:36-43)
        self.root_of_unity = (
            self.omega
            if poly_reduction == ReductionPolynomial.X_N_minus
            else self.psi
        )
        self.inverse_root_of_unity = host.modinv(self.root_of_unity, self.modulus)
        self.root_of_unity_size = (
            1 << (self.logn - 1)
            if poly_reduction == ReductionPolynomial.X_N_minus
            else 1 << self.logn
        )

        # power tables are built lazily (see the properties below): at
        # the big-ring sizes the TPU engines never read them — the MXU
        # digit-matmul plans are exponent algebra over root_of_unity —
        # and eagerly materializing 2 x 2^27 uint64 entries at logn 28
        # costs seconds and gigabytes per process for nothing
        self._fwd_table = None
        self._inv_table = None

        # n^-1 by Fermat (nttparameters.cu:170-173)
        self.n_inv = host.modinv(self.n, self.modulus)

    @property
    def forward_root_of_unity_table(self) -> np.ndarray:
        """Sequential powers of the root (nttparameters.cu:144-168),
        built on first access and cached."""
        if self._fwd_table is None:
            fwd = _power_table(self.root_of_unity, self.modulus.value,
                               self.root_of_unity_size)
            self._fwd_table = np.asarray(fwd, dtype=self.dtype)
        return self._fwd_table

    @property
    def inverse_root_of_unity_table(self) -> np.ndarray:
        if self._inv_table is None:
            inv = _power_table(self.inverse_root_of_unity,
                               self.modulus.value, self.root_of_unity_size)
            self._inv_table = np.asarray(inv, dtype=self.dtype)
        return self._inv_table

    # --- pools (nttparameters.cu:84-142): constants verbatim ---

    def _modulus_pool(self, bits: int) -> Modulus:
        if bits == 32:
            custom_assert(1 <= self.logn <= 25, "LOGN should be in range 1 to 25.")
            return Modulus32(469762049)
        custom_assert(1 <= self.logn <= 28, "LOGN should be in range 1 to 28.")
        return Modulus64(576460756061519873)

    def _omega_pool(self, bits: int) -> int:
        if bits == 32:
            return host.exp(900, 1 << (25 - self.logn), self.modulus)
        return host.exp(229929041166717729, 1 << (28 - self.logn), self.modulus)

    def _psi_pool(self, bits: int) -> int:
        if bits == 32:
            return host.exp(30, 1 << (25 - self.logn), self.modulus)
        return host.exp(4517306222, 1 << (28 - self.logn), self.modulus)

    # --- device-table permutation (nttparameters.cu:175-189) ---

    def gpu_root_of_unity_table(self, forward: bool = True) -> np.ndarray:
        """Bit-reversed twiddle table — the layout the transform engines use.

        On TPU this layout is what makes per-stage twiddles *static slices*:
        stage with m groups reads gpu_table[0:m] (X_N_minus) or
        gpu_table[m:2m] (X_N_plus); no runtime bit-reversal, no gathers.
        """
        table = (
            self.forward_root_of_unity_table
            if forward
            else self.inverse_root_of_unity_table
        )
        return bitrev_permute(table)
