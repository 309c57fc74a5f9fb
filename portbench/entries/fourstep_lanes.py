"""Entry adapter: `gpuntt_tpu_torch.fourstep_ntt_lanes` and
`fourstep_intt_lanes`, taken in turn as the traffic's `ops` list says.

Call i transforms pool operand i % pool_calls with ops[i % len(ops)] on
GPU-NTT's 4-step layout (cyclic, X^N - 1): the forward reads the (n2, n1)
transpose of the coefficients and writes the spectrum before the last
transpose; the inverse reads that layout back.
"""

from __future__ import annotations

import numpy as np

from portbench import operands
from portbench.reference import modpoly, primes


def counts(config, traffic) -> dict:
    """Output coefficients, and operand bytes (read once, written once)."""
    coefs = traffic["polys_per_call"] << config["logn"]
    return {"coefs": coefs, "bytes": 2 * 8 * coefs}


def operands_pool(config, traffic, seed, device) -> list:
    rows, n = traffic["polys_per_call"], 1 << config["logn"]
    x = operands.pool((traffic["pool_calls"], rows, n),
                      operands.row_moduli([config["q"]], rows), seed, device)
    return [x[i] for i in range(traffic["pool_calls"])]


def build(config, traffic, device):
    import gpuntt_tpu_torch as g

    if config["fourstep_reduction"] != "X^N-1":
        raise ValueError("the 4-step transforms are cyclic (X^N-1)")
    q, logn = config["q"], config["logn"]
    p = g.NTTParameters4Step(logn, g.ReductionPolynomial.X_N_minus, np.uint64,
                             factors=g.NTTFactors(g.Modulus64(q), *primes.root_pair(q, logn)))
    fns = {"ntt": g.fourstep_ntt_lanes, "intt": g.fourstep_intt_lanes}
    return [fns[op] for op in traffic["ops"]], g.FourStepPlan.from_params(p, device=device)


def call(state, pool, i):
    fns, plan = state
    return fns[i % len(fns)](pool[i % len(pool)], plan)


def reference(config, traffic, pool, i, mul):
    x = pool[i % len(pool)]
    q, logn = config["q"], config["logn"]
    n1, n2 = config["fourstep_dims"]
    qt = x.new_full((x.shape[0], 1), q)
    root = x.new_full((x.shape[0], 1), primes.root_pair(q, logn)[0])
    op = traffic["ops"][i % len(traffic["ops"])]
    fn = {"ntt": modpoly.fourstep_forward, "intt": modpoly.fourstep_inverse}[op]
    return fn(x, qt, root, n1, n2, mul)
