"""Entry adapter: `gpuntt_tpu_torch.ops.dispatch.rns_polymul_lanes` on RNS
ciphertexts held as 32-bit words.

A call multiplies `ciphertexts_per_call` pairs of ciphertexts row by row:
each ciphertext is `polys_per_ciphertext` polynomials of one residue row
per prime (every prime below 2^30), 2N-point negacyclic, row r under
prime r % L (the cyclic schedule), each row a run of int32 words.
Output: one (rows, N) int32 tensor of products.

The control (control.py) hands `reference` the float64 product: at 30-bit
moduli a * b < 2^60 and a float64 quotient is off by one at most, which
its correction repairs, so that product is exact here.  This entry reads
any product other than the exact `modpoly.mulmod` as the float product
at its own word's width, float32 (mulmod_f32), the nearest precision
below the configuration's 32-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import operands
from portbench.reference import modpoly, primes


def _rows(config, traffic) -> int:
    return (traffic["ciphertexts_per_call"] * config["polys_per_ciphertext"]
            * len(config["primes"]))


def counts(config, traffic) -> dict:
    """Output coefficients, and operand bytes (a and b read once, the
    product written once, 4-byte words), of one call."""
    coefs = _rows(config, traffic) << config["logn"]
    return {"coefs": coefs, "bytes": 3 * 4 * coefs}


def operands_pool(config, traffic, seed, device) -> list:
    """The pool as int32 words: batch i drawn by `operands.pool` (int64,
    reduced mod each row's prime) under its own seed, seed * pool_calls
    + i, and narrowed before the next is drawn, so that the device holds
    the int64 draw of one batch at most beside the int32 pool."""
    rows, n, calls = _rows(config, traffic), 1 << config["logn"], traffic["pool_calls"]
    q = operands.row_moduli(config["primes"], rows)
    x = torch.empty((calls, 2, rows, n), dtype=torch.int32, device=device)
    for i in range(calls):
        x[i] = operands.pool((2, rows, n), q, int(seed) * calls + i, device)
    return [(x[i, 0], x[i, 1]) for i in range(calls)]


def build(config, traffic, device):
    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops.dispatch import rns_polymul_lanes

    logn = config["logn"]
    poly = {"X^N+1": g.ReductionPolynomial.X_N_plus,
            "X^N-1": g.ReductionPolynomial.X_N_minus}[config["reduction"]]
    params = [g.NTTParameters(logn, poly, np.uint32,
                              factors=g.NTTFactors(g.Modulus32(q), *primes.root_pair(q, logn)))
              for q in config["primes"]]
    rows = _rows(config, traffic)
    return rns_polymul_lanes, g.RNSMergePlan.from_params(params, device=device), \
        np.arange(rows) % len(config["primes"])


def call(state, pool, i):
    entry, plan, schedule = state
    a, b = pool[i % len(pool)]
    return entry(a, b, plan, schedule)


def mulmod_f32(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a * b mod q with the quotient taken in float32 and one correction
    each way: exact only while a * b / q is exact to within one, far from
    it at 30 bits.  The control's product on 32-bit words; never the
    reference."""
    a, b = torch.broadcast_tensors(a, b)
    q = modpoly._q(q, a)
    quot = torch.floor(a.float() * b.float() / q.float()).long()
    r = a * b - quot * q
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def reference(config, traffic, pool, i, mul):
    a, b = pool[i % len(pool)]
    if mul is not modpoly.mulmod:  # the control's float product, at this word's width
        mul = mulmod_f32
    q = operands.row_moduli(config["primes"], a.shape[0]).to(a.device)
    psi = [primes.root_pair(int(v), config["logn"])[1] for v in q.flatten().tolist()]
    psi = q.new_tensor(psi).reshape(-1, 1)
    out = modpoly.polymul(a.long(), b.long(), q, psi, config["reduction"] == "X^N+1", mul)
    return out.to(torch.int32)
