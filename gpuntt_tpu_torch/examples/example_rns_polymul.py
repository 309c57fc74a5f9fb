"""HE-style RNS polynomial multiplication example — no reference
counterpart (the reference leaves the per-modulus pointwise loop and
the CRT lift entirely to the caller; its RNS surface is transforms
only, ntt.cu:2560-3059).

A polynomial over Z_Q (Q = product of a prime ladder) is held as
residue rows; one RNSPolynomialMultiplier call computes the cyclic
convolution residue-wise, and crt_reconstruct lifts the result back to
Z_Q, where it is checked against an exact big-integer cyclic schoolbook
product (O(N^2) Python integers: seconds at 2^12).  On the card, rings
of 2^12-2^17 take K12: two forward launches and the inverse with the
product fused into its first load (csrc/merge_u64.cu
rns_u64_polymul_inverse).

Usage: python -m gpuntt_tpu_torch.examples.example_rns_polymul [RING_SIZE_IN_LOG2] [MOD_COUNT] [--device=cuda|cpu]
Prints "All Correct." on success (check_result, common.cu:24-42).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import (Modulus64, NTTFactors, NTTParameters, ReductionPolynomial, crt_reconstruct,
                find_ntt_primes, ntt_root_pair)
from ..models.polymul import RNSPolynomialMultiplier
from . import _device


def rns_members(logn: int, count: int) -> list[NTTParameters]:
    """`count` distinct ~2^59 NTT-friendly primes with their 2N-th roots.

    X_N_minus: the 4-step/HE-style cyclic convolution basis."""
    out = []
    for q in find_ntt_primes(59, logn, count):
        om, psi = ntt_root_pair(q, logn)
        out.append(NTTParameters(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64,
                                 factors=NTTFactors(Modulus64(q), om, psi)))
    return out


def operands(logn: int, mod_count: int) -> tuple[list[int], list[int], list[int]]:
    """(qs, a, b): the ladder and two operands over Z_Q as Python ints."""
    qs = [m.modulus.value for m in rns_members(logn, mod_count)]
    big_q = int(np.prod(np.array(qs, dtype=object)))
    rng = np.random.default_rng(0)
    a = [int.from_bytes(rng.bytes(16), "little") % big_q for _ in range(1 << logn)]
    b = [int.from_bytes(rng.bytes(16), "little") % big_q for _ in range(1 << logn)]
    return qs, a, b


def compute(logn: int, mod_count: int, device) -> dict[str, np.ndarray]:
    """The operands' and the product's residue stacks, (mod_count, N)."""
    qs, a_int, b_int = operands(logn, mod_count)
    a = np.stack([np.array([x % q for x in a_int], dtype=np.uint64) for q in qs])
    b = np.stack([np.array([x % q for x in b_int], dtype=np.uint64) for q in qs])
    model = RNSPolynomialMultiplier(rns_members(logn, mod_count), device=device)
    return dict(a=a, b=b, product=model(a, b))


def schoolbook(a: list[int], b: list[int], big_q: int) -> list[int]:
    """The exact cyclic product mod (Q, X^N - 1): every a_i * b_j, summed
    as Python integers (numpy's object convolution), folded at N."""
    n = len(a)
    full = np.convolve(np.array(a, dtype=object), np.array(b, dtype=object))
    return [int(full[k] + (full[k + n] if k + n < 2 * n - 1 else 0)) % big_q
            for k in range(n)]


def main(argv=None) -> int:
    logn, mod_count, device = _device.parse(sys.argv[1:] if argv is None else argv, 10, 3)
    out = compute(logn, mod_count, device)
    qs, a_int, b_int = operands(logn, mod_count)
    got = crt_reconstruct(out["product"], qs)
    ok = got == schoolbook(a_int, b_int, int(np.prod(np.array(qs, dtype=object))))
    print("All Correct." if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
