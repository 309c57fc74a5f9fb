"""Entry adapter: `gpuntt_tpu_torch.ntt_lanes` and `intt_lanes`, the
port's GPU_NTT / GPU_INTT merge transforms, taken in turn as the
traffic's `ops` list says.

Call i transforms pool operand i % pool_calls with ops[i % len(ops)] on a
cyclic (X^N - 1) MergePlan of the configuration's ring, in the merge
order: the forward reads natural coefficients and writes the spectrum in
bit-reversed order; the inverse reads a spectrum in that order and
writes natural coefficients, N^-1 included.  At 2^27 the route is the
nested big ring: K7 on the outer 512 x 2^18 columns, K7 on the nested
columns of 512 rings of 512 x 512, K8 on 2^18 rows of 512.
"""

from __future__ import annotations

import numpy as np

from portbench import operands
from portbench.reference import modpoly, primes

# a 2^27 transform's launches on the nested big ring: K7 twice, K8 once
K7_LAUNCHES, K8_LAUNCHES = 2, 1


def counts(config, traffic) -> dict:
    """Output coefficients, operand bytes (read once, written once), and
    `kernel_bytes`: the bytes each kernel's launches of a call would move
    at least, each reading its operand once and writing its output once,
    for the per-kernel bandwidth shares ("k7", "k8")."""
    coefs = traffic["polys_per_call"] << config["logn"]
    word = 2 * 8 * coefs
    return {"coefs": coefs, "bytes": word,
            "kernel_bytes": {"k7": K7_LAUNCHES * word, "k8": K8_LAUNCHES * word}}


def operands_pool(config, traffic, seed, device) -> list:
    rows, n = traffic["polys_per_call"], 1 << config["logn"]
    x = operands.pool((traffic["pool_calls"], rows, n),
                      operands.row_moduli([config["q"]], rows), seed, device)
    return [x[i] for i in range(traffic["pool_calls"])]


def build(config, traffic, device):
    import gpuntt_tpu_torch as g

    if config["reduction"] != "X^N-1":
        raise ValueError("the merge transform cells are cyclic (X^N-1)")
    q, logn = config["q"], config["logn"]
    p = g.NTTParameters(logn, g.ReductionPolynomial.X_N_minus, np.uint64,
                        factors=g.NTTFactors(g.Modulus64(q), *primes.root_pair(q, logn)))
    fns = {"ntt": g.ntt_lanes, "intt": g.intt_lanes}
    return [fns[op] for op in traffic["ops"]], g.MergePlan.from_params(p, device=device)


def call(state, pool, i):
    fns, plan = state
    return fns[i % len(fns)](pool[i % len(pool)], plan)


def merge_forward(x, q, root, mul=modpoly.mulmod):
    """The cyclic transform by `root` of each row of (rows, N), in the
    merge order: X[br(k)] at position k."""
    modpoly.check_modulus(q)
    return modpoly.dft(x, q, root, mul)[:, modpoly.bitrev(x.shape[-1].bit_length() - 1,
                                                          x.device)]


def merge_inverse(z, q, root, mul=modpoly.mulmod):
    """The inverse of merge_forward: `z` holds a spectrum in the merge
    order; the result is its inverse transform, N^-1 included."""
    modpoly.check_modulus(q)
    return modpoly.inverse_dft(z[:, modpoly.bitrev(z.shape[-1].bit_length() - 1, z.device)],
                               q, root, mul)


def reference(config, traffic, pool, i, mul):
    x = pool[i % len(pool)]
    q, logn = config["q"], config["logn"]
    qt = x.new_full((x.shape[0], 1), q)
    root = x.new_full((x.shape[0], 1), primes.root_pair(q, logn)[0])
    op = traffic["ops"][i % len(traffic["ops"])]
    return {"ntt": merge_forward, "intt": merge_inverse}[op](x, qt, root, mul)
