"""Entry adapter: `gpuntt_tpu_torch.polymul_lanes` on one prime.

A call multiplies pool pair i % pool_calls modulo (q, X^N + 1); with
`zero_upper_half` both operands have degree < N/2, so the product never
wraps and is the plain product.
"""

from __future__ import annotations

import numpy as np

from portbench import operands
from portbench.reference import modpoly, primes


def counts(config, traffic) -> dict:
    """Output coefficients, and operand bytes (a and b read once, the
    product written once, int64 lanes; zero halves count as read)."""
    coefs = traffic["polys_per_call"] << config["logn"]
    return {"coefs": coefs, "bytes": 3 * 8 * coefs}


def operands_pool(config, traffic, seed, device) -> list:
    rows, n = traffic["polys_per_call"], 1 << config["logn"]
    x = operands.pool((traffic["pool_calls"], 2, rows, n),
                      operands.row_moduli([config["q"]], rows), seed, device)
    if traffic.get("zero_upper_half"):
        x[..., n // 2:] = 0
    return [(x[i, 0], x[i, 1]) for i in range(traffic["pool_calls"])]


def build(config, traffic, device):
    import gpuntt_tpu_torch as g

    if config["polymul_reduction"] != "X^N+1":
        raise ValueError("the polymul cells are negacyclic (X^N+1)")
    q, logn = config["q"], config["logn"]
    p = g.NTTParameters(logn, g.ReductionPolynomial.X_N_plus, np.uint64,
                        factors=g.NTTFactors(g.Modulus64(q), *primes.root_pair(q, logn)))
    return g.polymul_lanes, g.MergePlan.from_params(p, device=device)


def call(state, pool, i):
    entry, plan = state
    a, b = pool[i % len(pool)]
    return entry(a, b, plan)


def reference(config, traffic, pool, i, mul):
    a, b = pool[i % len(pool)]
    q, logn = config["q"], config["logn"]
    qt = a.new_full((a.shape[0], 1), q)
    psi = a.new_full((a.shape[0], 1), primes.root_pair(q, logn)[1])
    return modpoly.polymul(a, b, qt, psi, True, mul)
