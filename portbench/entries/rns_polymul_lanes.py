"""Entry adapter: `gpuntt_tpu_torch.ops.dispatch.rns_polymul_lanes` on RNS
ciphertexts.

A call multiplies `ciphertexts_per_call` pairs of ciphertexts row by row:
each ciphertext is `polys_per_ciphertext` polynomials of one residue row
per prime, 2N-point negacyclic, row r under prime r % L (the cyclic
schedule).  Output: one (rows, N) tensor of products.
"""

from __future__ import annotations

import numpy as np

from portbench import operands
from portbench.reference import modpoly, primes


def _rows(config, traffic) -> int:
    return (traffic["ciphertexts_per_call"] * config["polys_per_ciphertext"]
            * len(config["primes"]))


def counts(config, traffic) -> dict:
    """Output coefficients, and operand bytes (a and b read once, the
    product written once, int64 lanes), of one call."""
    coefs = _rows(config, traffic) << config["logn"]
    return {"coefs": coefs, "bytes": 3 * 8 * coefs}


def operands_pool(config, traffic, seed, device) -> list:
    rows, n = _rows(config, traffic), 1 << config["logn"]
    x = operands.pool((traffic["pool_calls"], 2, rows, n),
                      operands.row_moduli(config["primes"], rows), seed, device)
    return [(x[i, 0], x[i, 1]) for i in range(traffic["pool_calls"])]


def build(config, traffic, device):
    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops.dispatch import rns_polymul_lanes

    logn = config["logn"]
    poly = {"X^N+1": g.ReductionPolynomial.X_N_plus,
            "X^N-1": g.ReductionPolynomial.X_N_minus}[config["reduction"]]
    params = [g.NTTParameters(logn, poly, np.uint64,
                              factors=g.NTTFactors(g.Modulus64(q), *primes.root_pair(q, logn)))
              for q in config["primes"]]
    rows = _rows(config, traffic)
    return rns_polymul_lanes, g.RNSMergePlan.from_params(params, device=device), \
        np.arange(rows) % len(config["primes"])


def call(state, pool, i):
    entry, plan, schedule = state
    a, b = pool[i % len(pool)]
    return entry(a, b, plan, schedule)


def reference(config, traffic, pool, i, mul):
    a, b = pool[i % len(pool)]
    q = operands.row_moduli(config["primes"], a.shape[0]).to(a.device)
    psi = [primes.root_pair(int(v), config["logn"])[1] for v in q.flatten().tolist()]
    psi = q.new_tensor(psi).reshape(-1, 1)
    return modpoly.polymul(a, b, q, psi, config["reduction"] == "X^N+1", mul)
