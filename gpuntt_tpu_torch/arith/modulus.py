"""Barrett modulus descriptor.

Rebuild of the reference's `Modulus<T>` (modular_arith.cuh:28-57): holds
the modulus value, its bit length `bit = floor(log2 q) + 1`, and the
Barrett constant `mu = floor(2^(2*bit+1) / q)`.

The same constants drive both the host (exact-int) path and the TPU
(limb-decomposed) path, so every reduction is bit-identical to the
reference for q <= 30 bits (32-bit data) / q <= 62 bits (64-bit data)
(constraint comment: modular_arith.cuh:66-67).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Modulus:
    """Word-sized prime-field modulus with precomputed Barrett constants."""

    value: int
    bits: int = 32  # data word width: 32 or 64 (selects Data32 vs Data64 semantics)
    bit: int = field(init=False)
    mu: int = field(init=False)

    def __post_init__(self):
        if self.value <= 0:
            raise ValueError("modulus must be positive")
        if self.bits not in (32, 64):
            raise ValueError("bits must be 32 or 64")
        # bit_generator: static_cast<T>(log2(value) + 1) (modular_arith.cuh:44-47).
        # For powers of two and all values below 2^53 this equals bit_length();
        # replicate with exact integer arithmetic.
        bit = self.value.bit_length()
        object.__setattr__(self, "bit", bit)
        # mu_generator (modular_arith.cuh:49-56)
        mu = (1 << (2 * bit + 1)) // self.value
        object.__setattr__(self, "mu", mu)

    @property
    def max_data(self) -> int:
        return (1 << self.bits) - 1

    def __int__(self) -> int:
        return self.value


def Modulus32(value: int) -> Modulus:
    """typedef Modulus<Data32> (modular_arith.cuh:59)."""
    return Modulus(value, bits=32)


def Modulus64(value: int) -> Modulus:
    """typedef Modulus<Data64> (modular_arith.cuh:60)."""
    return Modulus(value, bits=64)
