"""NTT-friendly primes and their roots, worked out from a configuration.

A frozen copy of the port's prime search (`gpuntt_tpu_torch.arith.host`
`is_prime_u64`, `find_ntt_primes`, `ntt_root_pair`), so that the benchmark
names its moduli and roots without importing the program it measures.
"""

from __future__ import annotations

_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact for n < 2^64."""
    for p in _WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(bits: int, logn: int, count: int) -> list[int]:
    """`count` primes of exactly `bits` bits with q = k * 2^(logn+1) + 1,
    ascending from the bottom of the bit range."""
    step = 2 << logn
    out, k = [], max(1, ((1 << (bits - 1)) - 1) // step + 1)
    while len(out) < count:
        q = k * step + 1
        k += 1
        if q.bit_length() > bits:
            raise ValueError(f"fewer than {count} {bits}-bit NTT primes for logn {logn}")
        if q.bit_length() == bits and is_prime(q):
            out.append(q)
    return out


def root_pair(q: int, logn: int) -> tuple[int, int]:
    """(omega, psi): psi = g^((q-1)/2N) for the smallest quadratic
    non-residue g, a primitive 2N-th root of unity; omega = psi^2, a
    primitive N-th root."""
    two_n = 2 << logn
    if (q - 1) % two_n:
        raise ValueError(f"q = {q} has no 2^{logn + 1}-th root of unity")
    g = 3
    while pow(g, (q - 1) // 2, q) == 1:
        g += 1
    psi = pow(g, (q - 1) // two_n, q)
    return pow(psi, 2, q), psi
