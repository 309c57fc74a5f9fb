"""Operands drawn from the seed on the device, in one large call a pool.

Every value is drawn from [0, 2^63 - 1) and reduced modulo its row's
prime: within 1/16 of uniform on [0, q) for the 59-bit primes here, and
always in range.  The same seed, shape and device give the same pool.
"""

from __future__ import annotations

import torch

_HIGH = (1 << 63) - 1


def pool(shape: tuple, q_rows: torch.Tensor, seed: int, device) -> torch.Tensor:
    """An int64 tensor of `shape` = (..., rows, N), row r reduced modulo
    q_rows[r] (a (rows, 1) int64 tensor)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randint(0, _HIGH, shape, generator=gen, dtype=torch.int64, device=device)
    return x.remainder_(q_rows.to(device))


def row_moduli(primes, rows: int) -> torch.Tensor:
    """(rows, 1): row r under primes[r % len(primes)], the cyclic schedule."""
    qs = torch.tensor([int(q) for q in primes], dtype=torch.int64)
    return qs[torch.arange(rows) % len(qs)].reshape(-1, 1)
