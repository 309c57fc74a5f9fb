"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same card, at
every logn the kernels take (u64 12-17, u32 8-25) and both reduction
polynomials, on any input word; wide and narrow moduli against the
golden NTTCPU; the u32 route's launch counters; the wrappers'
refusals; CUDA-event timing.  Exact equality throughout.

This file imports neither jax nor gpuntt_tpu, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
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


def _u32_plan(logn, poly, card, bits=None):
    if bits is None:
        p = tg.NTTParameters(logn, poly, np.uint32)
    else:
        q = tg.find_ntt_primes(bits, logn, 1)[0]
        omega, psi = tg.ntt_root_pair(q, logn)
        p = tg.NTTParameters(logn, poly, np.uint32,
                             factors=tg.NTTFactors(tg.Modulus32(q), omega, psi))
    return p, tg.MergePlan.from_params(p, device=card)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(8, 26))
def test_u32_kernels_match_plain_on_card(card, logn, poly):
    """Every u32 ring size the route takes, on any u32 word; the launch
    is counted against the TPU kernel whose range served it."""
    p, plan = _u32_plan(logn, poly, card)
    batch = 1 if logn == 25 else 2
    x = torch.from_numpy(np.random.default_rng(logn).integers(
        0, 1 << 32, size=(batch, p.n), dtype=np.int64)).to(card)
    hm32.reset_counts()
    fx = hm32.merge_u32_fwd(x, plan)
    ix = hm32.merge_u32_inv(x, plan)
    torch.cuda.synchronize()
    k = hm32.tpu_kernel(logn)
    assert {s.name: (s.launches, s.plain_calls) for s in hm32.KERNELS
            if s.launches or s.plain_calls} == \
        {hm32.FORWARD[k].name: (1, 0), hm32.INVERSE[k].name: (1, 0)}
    assert torch.equal(fx, hm32.merge_u32_fwd_plain(x, plan))
    assert torch.equal(ix, hm32.merge_u32_inv_plain(x, plan))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("bits", [None, 30, 20])
def test_u32_moduli_against_golden_on_card(card, bits, poly):
    """The pool prime, the widest q the route admits (30 bits) and a
    20-bit q at logn 14, batch 1 and 128: ntt, intt and polymul."""
    p, plan = _u32_plan(14, poly, card, bits)
    q = p.modulus.value
    gen = tg.NTTCPU(p)
    rng = np.random.default_rng(bits or 29)
    for batch in (1, 128):
        x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64).astype(np.uint32)
        y = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64).astype(np.uint32)
        hm32.reset_counts()
        np.testing.assert_array_equal(tg.ntt(x, plan), gen.ntt(x))
        np.testing.assert_array_equal(tg.intt(x, plan), gen.intt(x))
        np.testing.assert_array_equal(tg.polymul(x, y, plan),
                                      gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))
        assert hm32.FORWARD["K4"].launches == 3 and hm32.INVERSE["K4"].launches == 2
        assert sum(k.plain_calls for k in hm32.KERNELS) == 0


def test_u32_route_runs_k4_k5_k6_on_card(card):
    """ntt_lanes / intt_lanes at 2^16, 2^17 and 2^20 launch the
    counterparts of K4, K5 and K6 once each, and no plain version."""
    hm32.reset_counts()
    for logn in (16, 17, 20):
        p, plan = _u32_plan(logn, tg.ReductionPolynomial.X_N_plus, card)
        x = torch.from_numpy(np.random.default_rng(logn).integers(
            0, p.modulus.value, size=(3, p.n), dtype=np.int64)).to(card)
        assert torch.equal(tg.intt_lanes(tg.ntt_lanes(x, plan), plan), x)
    assert [(k.launches, k.plain_calls) for k in hm32.KERNELS] == [(1, 0)] * 6


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
    _, plan32 = _u32_plan(12, tg.ReductionPolynomial.X_N_plus, card)
    with pytest.raises(tg.NTTDispatchError):
        hm32.merge_u32_fwd(x.cpu(), plan32)
    with pytest.raises(tg.NTTDispatchError):
        hm32.merge_u32_inv(x.to(torch.int32), plan32)


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
