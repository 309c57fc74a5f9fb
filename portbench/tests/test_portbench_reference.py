"""The reference against schoolbook products and the port's plain 4-step,
and its control against the exact product."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import modpoly, primes


def _schoolbook(a, b, q, negacyclic):
    n = len(a)
    full = [0] * (2 * n)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            full[i + j] += x * y
    sign = -1 if negacyclic else 1
    return [(full[k] + sign * full[k + n]) % q for k in range(n)]


@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("logn", [1, 3, 6])
def test_polymul_is_the_schoolbook_product(negacyclic, logn):
    qs = primes.ntt_primes(59, logn, 3)
    rng = np.random.default_rng(logn)
    a = torch.tensor([[int(v) % q for v in rng.integers(0, 1 << 62, 1 << logn)] for q in qs])
    b = torch.tensor([[int(v) % q for v in rng.integers(0, 1 << 62, 1 << logn)] for q in qs])
    q = torch.tensor(qs).reshape(-1, 1)
    psi = torch.tensor([primes.root_pair(v, logn)[1] for v in qs]).reshape(-1, 1)
    got = modpoly.polymul(a, b, q, psi, negacyclic)
    for r, qr in enumerate(qs):
        assert got[r].tolist() == _schoolbook(a[r].tolist(), b[r].tolist(), qr, negacyclic)


def test_mulmod_is_exact_and_the_control_is_not():
    q = primes.ntt_primes(59, 15, 1)[0]
    rng = np.random.default_rng(0)
    a = [int(v) % q for v in rng.integers(0, 1 << 62, 4096)]
    b = [int(v) % q for v in rng.integers(0, 1 << 62, 4096)]
    want = [x * y % q for x, y in zip(a, b)]
    assert modpoly.mulmod(torch.tensor(a), torch.tensor(b), q).tolist() == want
    control = modpoly.mulmod_f64(torch.tensor(a), torch.tensor(b), q).tolist()
    assert sum(c != w for c, w in zip(control, want)) > 4096 // 2


def test_moduli_past_the_limit_are_refused():
    with pytest.raises(ValueError):
        modpoly.polymul(torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, 4, dtype=torch.int64),
                        torch.tensor([[(1 << 61) - 1]]), torch.tensor([[1]]), True)


def test_fourstep_layout_matches_the_port_plain_path():
    g = pytest.importorskip("gpuntt_tpu_torch")
    logn = 12
    q = primes.ntt_primes(59, logn, 1)[0]
    omega, psi = primes.root_pair(q, logn)
    p = g.NTTParameters4Step(logn, g.ReductionPolynomial.X_N_minus, np.uint64,
                             factors=g.NTTFactors(g.Modulus64(q), omega, psi))
    plan = g.FourStepPlan.from_params(p, device="cpu")
    x = torch.randint(0, q, (2, 1 << logn), generator=torch.Generator().manual_seed(3))
    qt, root = torch.full((2, 1), q), torch.full((2, 1), omega)
    assert torch.equal(g.fourstep_ntt_lanes(x, plan),
                       modpoly.fourstep_forward(x, qt, root, p.n1, p.n2))
    assert torch.equal(g.fourstep_intt_lanes(x, plan),
                       modpoly.fourstep_inverse(x, qt, root, p.n1, p.n2))
