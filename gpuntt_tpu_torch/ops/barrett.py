"""Vectorized exact modular arithmetic on torch lanes.

The port of the JAX package's ops/barrett.py.  64-bit data are
int64 tensors holding u64 bit patterns (see limb.py); 32-bit data are
int64 tensors holding values in [0, 2^32), and every 32-bit result is
masked back to the word, so wrap-around matches the JAX uint32 lanes.
Moduli and constants are Python ints.

Each function mirrors its JAX namesake bit for bit, on any operands the
namesake accepts (edge operands near 2^64 - 1 included):

- `barrett_mul32/64` the reference's Barrett with the exact `bit-2` /
  `bit+3` shift schedule (modular_arith.cuh:312-339), each the wide
  reduction of its operands' product;
- `barrett_reduce32/64` the same schedule on one word
  (modular_arith.cuh:346-355), and `barrett_reduce_wide32/64` on a
  product-sized z < q^2: one int64 word for the 32-bit class, the
  (hi, lo) words of a 128-bit z for the 64-bit class
  (modular_arith.cuh:420-451);
- `shoup_mul32/64` a product by a constant w with its companion
  w' = floor(w * 2^word / q);
- `shoup_mul64_lazy` the same without the final subtract, from the
  approximate high word (result < 3q for any x);
- `reduce_signed*` / `centered*` the signed load and centered store
  (modular_arith.cuh:371-405);
- `reduce_forced32/64` x mod q for any word x (modular_arith.cuh:407-418);
- `shoup_mul32_lazy` / `cond_sub32` the lazy 32-bit Shoup product and
  one normalisation step, from which the u32 kernels' reduce-on-load
  is built (csrc/merge_u32.cuh).
"""

from __future__ import annotations

import numpy as np
import torch

from .limb import M32, mulhi, mulhi_approx, shr128_lo64, signed, srl, uge, ult


# ---------------------------------------------------------------- 32-bit


def modadd32(a, b, q: int):
    """(a + b) mod q; q <= 2^30 so no word overflow (cuh:270-276)."""
    s = (a + b) & M32
    return torch.where(s >= q, s - q, s)


def modsub32(a, b, q: int):
    """(a - b) mod q via +q (cuh:280-287)."""
    d = (a + q - b) & M32
    return torch.where(d >= q, d - q, d)


def barrett_reduce_wide32(z, q: int, bit: int, mu: int):
    """z mod q for a 64-bit z < q^2 and a 32-bit-class q, the reference
    schedule (modular_arith.cuh:420-436, the T1* overload)."""
    w = srl(z, bit - 2) & M32
    w2 = srl(w * mu, bit + 3) & M32
    res = (z - w2 * q) & M32
    return torch.where(res >= q, res - q, res)


def barrett_mul32(a, b, q: int, bit: int, mu: int):
    """Exact (a*b) mod q, reference schedule (modular_arith.cuh:316-326)."""
    return barrett_reduce_wide32(a * b, q, bit, mu)


def barrett_reduce32(x, q: int, bit: int, mu: int):
    """x mod q for a u32 word x (the low 32 bits of the lane),
    reference schedule (modular_arith.cuh:346-355)."""
    return barrett_reduce_wide32(x & M32, q, bit, mu)


def shoup_mul32(x, w, w_shoup, q: int):
    """x * w mod q with precomputed w' = floor(w << 32 / q); w < q, x < q."""
    hi = srl(x * w_shoup, 32)
    r = (x * w - hi * q) & M32
    return torch.where(r >= q, r - q, r)


def shoup_mul32_lazy(x, w, w_shoup, q: int):
    """x*w mod q + e*q with e in {0, 1}: result < 2q for any u32 x."""
    hi = srl(x * w_shoup, 32)
    return (x * w - hi * q) & M32


def cond_sub32(x, c: int):
    """x - c if x >= c else x (one normalisation step)."""
    return torch.where(x >= c, x - c, x)


def reduce_forced32(x, q: int):
    """x mod q for ANY u32 word x (the low 32 bits of the lane) and any
    q >= 2 (modular_arith.cuh:407-418): a lazy Shoup product by 1 with
    c = floor(2^32 / q) undershoots the quotient by at most 1, so r < 2q
    and one conditional subtract canonicalises."""
    return cond_sub32(shoup_mul32_lazy(x & M32, 1, (1 << 32) // q, q), q)


def reduce_signed32(x, q: int):
    """int32 bit pattern -> [0, q) (modular_arith.cuh:372-385): q + x for
    x < 0, wrapping in the word, which gives q - |x| for |x| <= q."""
    neg = ((x >> 31) & 1) == 1
    return torch.where(neg, (x + q) & M32, x)


def centered32(x, q: int):
    """[0, q) -> [-q/2, q/2) as signed values (modular_arith.cuh:389-405)."""
    return torch.where(x > (q >> 1), x - q, x)


# ---------------------------------------------------------------- 64-bit


def modadd64(a, b, q: int):
    s = a + b  # a, b < q <= 2^62: no 64-bit overflow
    return torch.where(uge(s, q), s - q, s)


def modsub64(a, b, q: int):
    d = a + q - b
    return torch.where(uge(d, q), d - q, d)


def barrett_reduce_wide64(z_hi, z_lo, q: int, bit: int, mu: int):
    """z mod q for the 128-bit z = (z_hi, z_lo) < q^2 and a 62-bit-class
    q, the reference schedule (modular_arith.cuh:438-451)."""
    mu = signed(mu)
    w = shr128_lo64(z_hi, z_lo, bit - 2)
    w2 = shr128_lo64(mulhi(w, mu), w * mu, bit + 3)
    res = z_lo - w2 * q
    return torch.where(uge(res, q), res - q, res)


def barrett_mul64(a, b, q: int, bit: int, mu: int):
    """Exact (a*b) mod q, reference schedule (modular_arith.cuh:328-338)."""
    return barrett_reduce_wide64(mulhi(a, b), a * b, q, bit, mu)


def barrett_reduce64(x, q: int, bit: int, mu: int):
    """The reference schedule on one u64 word x (a 128-bit z with a zero
    high word)."""
    return barrett_reduce_wide64(0, x, q, bit, mu)


def shoup_mul64(x, w, w_shoup, q: int):
    """x * w mod q with w' = floor(w << 64 / q); w < q <= 2^62, x < q."""
    r = x * w - mulhi(x, w_shoup) * q
    return torch.where(uge(r, q), r - q, r)


def shoup_mul64_lazy(x, w, w_shoup, q: int):
    """x*w mod q + e*q with e in {0,1,2}; result < 3q for any x < 2^64
    (Shoup bound 2q plus <= 1q from the approximate high word)."""
    return x * w - mulhi_approx(x, w_shoup) * q


def reduce_signed64(x, q: int):
    """int64 -> [0, q): q + x for x < 0 (and nothing else)."""
    return torch.where(x < 0, x + q, x)


def centered64(x, q: int):
    """[0, q) -> [-q/2, q/2) as int64."""
    return torch.where(ult(q >> 1, x), x - q, x)


def cond_sub64(x, c: int):
    c = signed(c)
    return torch.where(uge(x, c), x - c, x)


def reduce_forced64(x, q: int):
    """x mod q for ANY u64 x and any q < 2^63 (modular_arith.cuh:407-418):
    the quotient estimate from c = floor(2^64 / q) undershoots by at
    most 1, so r < 2q and one conditional subtract canonicalises."""
    c = signed((1 << 64) // q)
    r = x - mulhi(x, c) * q
    return torch.where(uge(r, q), r - q, r)


# ------------------------------------------------- host-side table prep


def shoup_companion(values, q: int, word: int) -> np.ndarray:
    """floor(v << word / q) for each v, exact (host side)."""
    values = np.asarray(values)
    if word == 32:
        # q < 2^30: exact in uint64
        v = values.astype(np.uint64)
        return ((v << np.uint64(32)) // np.uint64(q)).astype(np.uint32)
    from .. import _native

    if values.size >= 1 << 10 and _native.available():
        return _native.shoup_table(values, q)
    vals = [(int(v) << word) // q for v in values.ravel()]
    return np.array(vals, dtype=np.uint64).reshape(values.shape)
