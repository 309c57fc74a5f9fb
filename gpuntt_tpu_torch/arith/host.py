"""Host-side exact modular arithmetic (parameter generation path).

Rebuild of the reference's `OPERATOR<T>` = BarrettOperations (host)
(modular_arith.cuh:62-156).  Python integers are arbitrary precision, so
the Barrett dance is only kept where it is semantically load-bearing;
where Barrett is exact (it always produces the canonical residue for
inputs < q after its single conditional subtraction), we use plain
modular arithmetic, which yields bit-identical tables.

`barrett_mult` below replicates the exact `bit-2` / `bit+3` shift
schedule (modular_arith.cuh:90-107) and is used by tests to prove that
the plain-mod shortcut and the TPU limb kernels agree with it.
"""

from __future__ import annotations

from .modulus import Modulus


def add(a: int, b: int, m: Modulus) -> int:
    """(a + b) mod q, single conditional subtraction (modular_arith.cuh:71-77)."""
    s = a + b
    return s - m.value if s >= m.value else s


def sub(a: int, b: int, m: Modulus) -> int:
    """(a - b) mod q via +q (modular_arith.cuh:80-86)."""
    d = a + m.value - b
    return d - m.value if d >= m.value else d


def barrett_mult(a: int, b: int, m: Modulus) -> int:
    """Exact replica of OPERATOR<T>::mult (modular_arith.cuh:90-107).

    Valid (== a*b mod q) for moduli up to 30 bits (32-bit data) and
    62 bits (64-bit data); the word mask models the C truncation.
    """
    mask = m.max_data if m.bits == 64 else 0xFFFFFFFF
    wide_mask = (1 << (2 * m.bits)) - 1
    z = (a * b) & wide_mask
    r = z >> (m.bit - 2)
    r = (r * m.mu) & wide_mask
    r = r >> (m.bit + 3)
    r = (r * m.value) & wide_mask
    z = (z - r) & wide_mask
    result = z & mask
    return result - m.value if result >= m.value else result


def mult(a: int, b: int, m: Modulus) -> int:
    """(a * b) mod q.  Equals barrett_mult for in-range inputs."""
    return (a * b) % m.value


def exp(base: int, exponent: int, m: Modulus) -> int:
    """(base ^ exponent) mod q (modular_arith.cuh:111-128)."""
    return pow(base, exponent, m.value)


def modinv(a: int, m: Modulus) -> int:
    """a^(q-2) mod q — Fermat inverse, prime q (modular_arith.cuh:132-136)."""
    return pow(a, m.value - 2, m.value)


def reduce(a: int, m: Modulus) -> int:
    """a mod q (modular_arith.cuh:139-155)."""
    return a % m.value


def reduce_signed(a: int, m: Modulus) -> int:
    """Signed -> [0, q) conversion used for signed NTT inputs.

    Mirrors OPERATOR_GPU::reduce(signed) (modular_arith.cuh:372-385):
    negative values map to q - (-a) WITHOUT further reduction; the caller
    guarantees |a| <= q.
    """
    if a < 0:
        return m.value - (-a)
    return a


def centered_reduction(a: int, m: Modulus) -> int:
    """[0, q) -> [-q/2, q/2) (modular_arith.cuh:387-405)."""
    half = m.value >> 1
    return a - m.value if a > half else a


def crt_reconstruct(residues, qs):
    """Exact CRT lift of RNS residues to Z_{prod(qs)} (host side).

    `residues` is a (..., mod_count, N) array-like of canonical
    residues (row i modulo qs[i]); returns a (..., N) nested list of
    Python ints in [0, prod(qs)).  This is the host-side check HE
    callers pair with the RNS transforms (the reference leaves both
    the pointwise loop and the lift to the caller).
    """
    qs = [int(q) for q in qs]
    big_q = 1
    for q in qs:
        big_q *= q
    # garner-style precompute: e_i = (Q/q_i) * ((Q/q_i)^-1 mod q_i)
    es = []
    for q in qs:
        m = big_q // q
        es.append(m * pow(m, -1, q))

    def lift(stack):
        # stack: sequence of mod_count rows, each length-N
        if len(stack) != len(qs):
            raise ValueError(
                f"residue stack has {len(stack)} rows for {len(qs)} moduli "
                f"(expected a (..., mod_count, N) layout)")
        rows = [list(map(int, r)) for r in stack]
        n = len(rows[0])
        return [sum(e * rows[i][j] for i, e in enumerate(es)) % big_q
                for j in range(n)]

    import numpy as _np

    arr = _np.asarray(residues, dtype=_np.uint64)
    if arr.ndim == 2:
        return lift(arr)
    return [crt_reconstruct(a, qs) for a in arr]


# ------------------------------------------- NTT-friendly prime search
#
# The reference ships fixed prime pools (nttparameters.cu:84-142); RNS
# tests, examples, and fuzzing need ARBITRARY ladders of NTT-friendly
# primes, and the derivation loop was copy-pasted nine times across the
# tree before living here.

def is_prime_u64(n: int) -> bool:
    """Deterministic Miller-Rabin, exact for n < 2^64."""
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
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


def find_ntt_primes(bits: int, logn: int, count: int) -> list[int]:
    """`count` distinct `bits`-bit primes q = k * 2^(logn+1) + 1 (so a
    2N-th root of unity exists), ascending from the bottom of the
    bit range."""
    step = 2 << logn
    out, k = [], max(1, ((1 << (bits - 1)) - 1) // step + 1)
    while len(out) < count:
        q = k * step + 1
        k += 1
        if q.bit_length() > bits:
            raise ValueError(
                f"fewer than {count} {bits}-bit NTT primes for logn {logn}")
        if q.bit_length() == bits and is_prime_u64(q):
            out.append(q)
    return out


def ntt_root_pair(q: int, logn: int) -> tuple[int, int]:
    """(omega, psi) for modulus q: psi a primitive 2N-th root of unity
    (from the smallest generator), omega = psi^2 — the NTTFactors
    convention (nttparameters.cuh:38-54)."""
    two_n = 2 << logn
    if (q - 1) % two_n:
        raise ValueError(f"q = {q} has no 2^{logn + 1}-th root of unity")
    g = 3
    while pow(g, (q - 1) // 2, q) == 1:
        g += 1
    psi = pow(g, (q - 1) // two_n, q)
    return pow(psi, 2, q), psi
