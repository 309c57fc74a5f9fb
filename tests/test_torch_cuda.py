"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same card, at
every logn the kernels take and both reduction polynomials, on any u64
input; the wide and narrow moduli against the golden NTTCPU; the
wrappers' refusals; CUDA-event timing.  Exact equality throughout.

This file imports neither jax nor gpuntt_tpu, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64
from gpuntt_tpu_torch.utils.timing import time_cuda

pytestmark = pytest.mark.cuda

POLYS = [tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", [12, 13, 14, 15, 16, 17])
def test_kernels_match_plain_on_card(card, logn, poly):
    p = tg.NTTParameters(logn, poly, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    rng = np.random.default_rng(logn)
    x = from_numpy_u64(rng.integers(0, 1 << 64, size=(3, p.n), dtype=np.uint64,
                                    endpoint=False), card)
    b = from_numpy_u64(rng.integers(0, p.modulus.value, size=(3, p.n),
                                    dtype=np.uint64), card)
    hm.reset_counts()
    fx = hm.merge_u64_fwd(x, plan)
    ix = hm.merge_u64_inv(x, plan)
    px = hm.merge_u64_polymul_inv(fx, b, plan)
    torch.cuda.synchronize()
    assert [(k.launches, k.plain_calls) for k in hm.KERNELS] == [(1, 0)] * 3
    assert torch.equal(fx, hm.merge_u64_fwd_plain(x, plan))
    assert torch.equal(ix, hm.merge_u64_inv_plain(x, plan))
    assert torch.equal(px, hm.merge_u64_polymul_inv_plain(fx, b, plan))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("bits", [62, 54, 46])
def test_wide_and_narrow_moduli_on_card(card, bits, poly):
    """q in [2^61, 2^62), a 54-bit and a 46-bit q, at batch 1 and 3."""
    q = tg.find_ntt_primes(bits, 14, 1)[0]
    omega, psi = tg.ntt_root_pair(q, 14)
    p = tg.NTTParameters(14, poly, np.uint64,
                         factors=tg.NTTFactors(tg.Modulus64(q), omega, psi))
    plan = tg.MergePlan.from_params(p, device=card)
    gen = tg.NTTCPU(p)
    rng = np.random.default_rng(bits)
    for batch in (1, 3):
        x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
        y = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
        np.testing.assert_array_equal(tg.ntt(x, plan), gen.ntt(x))
        np.testing.assert_array_equal(tg.intt(x, plan), gen.intt(x))
        np.testing.assert_array_equal(tg.polymul(x, y, plan),
                                      gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))


def test_wrappers_refuse_on_card(card):
    p = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    x = torch.zeros((2, p.n), dtype=torch.int64, device=card)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.to(torch.int32), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.cpu(), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_inv(x.reshape(-1, 2).t(), plan)


def test_numpy_entries_round_trip_on_card(card):
    p = tg.NTTParameters(16, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    x = np.random.default_rng(1).integers(0, p.modulus.value, size=(4, p.n),
                                          dtype=np.uint64)
    np.testing.assert_array_equal(to_numpy_u64(tg.ntt_lanes(from_numpy_u64(x, card), plan)),
                                  tg.NTTCPU(p).ntt(x))
    np.testing.assert_array_equal(tg.intt(tg.ntt(x, plan), plan), x)


def test_time_cuda(card):
    x = torch.ones(1 << 20, device=card)
    ms, spread = time_cuda(lambda: x.mul_(1.0), warmup=1, repeats=5, inner=3)
    assert ms > 0 and spread >= 0
