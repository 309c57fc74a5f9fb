"""Unsigned 64-bit arithmetic on int64 tensors that hold u64 bit patterns.

PyTorch's `uint64` tensors lack most CPU operators (`+`, `>>`, `<`
raise NotImplementedError), so the port holds a u64 word as the int64
with the same 64 bits.  Addition, subtraction and the low word of a
product wrap modulo 2^64 in two's complement exactly as they do
unsigned; what differs is handled here:

- `>>` on int64 is arithmetic, so a logical shift masks after shifting;
- unsigned order is signed order after flipping the sign bit;
- the high word of a 64x64 product is rebuilt from 32-bit limbs.

Python-int constants go through `signed()` first, since a value at or
above 2^63 does not fit an int64 scalar.  (The JAX package's (hi, lo)
uint32 pair representation is a TPU workaround and has no counterpart.)
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
SIGN = -(1 << 63)  # the int64 whose bit pattern is 2^63


def signed(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    v = int(v) & ((1 << 64) - 1)
    return v - (1 << 64) if v >= 1 << 63 else v


def srl(a, s: int):
    """Logical right shift by a static amount s in [0, 64)."""
    if s == 0:
        return a
    return (a >> s) & ((1 << (64 - s)) - 1)


def ult(a, b):
    """Unsigned a < b."""
    return (a ^ SIGN) < (b ^ SIGN)


def uge(a, b):
    """Unsigned a >= b."""
    return (a ^ SIGN) >= (b ^ SIGN)


def mulhi(a, b):
    """High 64 bits of the 128-bit product of two u64 patterns."""
    al, ah = a & M32, srl(a, 32)
    bl, bh = b & M32, srl(b, 32)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    mid = srl(ll, 32) + (lh & M32) + (hl & M32)  # < 3 * 2^32: exact
    return ah * bh + srl(lh, 32) + srl(hl, 32) + srl(mid, 32)


def mulhi_approx(a, b):
    """mulhi without the lo*lo partial: low by at most 1.  Mirrors the
    JAX package's mul64x64_hi_approx, which its lazy Shoup product
    uses, bit for bit."""
    al, ah = a & M32, srl(a, 32)
    bl, bh = b & M32, srl(b, 32)
    lh = al * bh
    hl = ah * bl
    return ah * bh + srl(lh, 32) + srl(hl, 32) + srl((lh & M32) + (hl & M32), 32)


def shr128_lo64(hi, lo, s: int):
    """Low 64 bits of the 128-bit (hi, lo) shifted right by s in [0, 128)."""
    if s == 0:
        return lo
    if s < 64:
        return srl(lo, s) | (hi << (64 - s))
    return srl(hi, s - 64)


def from_numpy_u64(x, device=None) -> torch.Tensor:
    """numpy uint64 -> int64 tensor of the same bits (a view on CPU)."""
    x = np.ascontiguousarray(x, dtype=np.uint64)
    return torch.from_numpy(x.view(np.int64)).to(device)


def to_numpy_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 bit patterns -> numpy uint64."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)
