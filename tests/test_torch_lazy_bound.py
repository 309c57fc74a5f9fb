"""The register-pass wrappers refuse a modulus past their lazy butterflies' bound.

K1-K3 (merge_u64_fwd / _inv / _polymul_inv), K12 (rns_u64_fwd / _inv /
_polymul_inv), K7 (merge_u64_large_colfwd / _colinv), K7'
(col_phase_local, the _local entries), K13-col (rns_u64_large_colfwd /
_colinv), K9 and K11-col (fourstep_u64_col, fourstep_u32_col) and K14
(rns_fourstep_u64_col) keep values below 4q inside a launch, which fits
the word only for q < 2^62 (u64) or q < 2^30 (u32); so does K17
(kmerge_u32).  K15 (kmerge_u64) runs a canonical instance of its passes
for q in [2^62, 2^63) and refuses only q >= 2^63, where no u64 plan can
be built (its case replaces the plan's q).  No route hands them
a wider q (each route's `covers`, LargePlan's constructors and the dist
plan's colmat hold it); the wrappers refuse one before any launch, on
any device, as K8's does, whatever `takes` would let through.  The
largest NTT prime below the bound still runs (the plain versions, on
the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_kmerge as hk
from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.utils.kernel_bench import largest_ntt_prime

MINUS = tg.ReductionPolynomial.X_N_minus
LOGN = 12


def params(q: int, logn: int = LOGN, dtype=np.uint64, four: bool = False):
    om, psi = tg.ntt_root_pair(q, logn)
    mod = tg.Modulus64(q) if dtype == np.uint64 else tg.Modulus32(q)
    cls = tg.NTTParameters4Step if four else tg.NTTParameters
    return cls(logn, MINUS, dtype, factors=tg.NTTFactors(mod, om, psi))


def words(n: int, batch: int = 2) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(n).integers(
        0, 1 << 62, size=(batch, n), dtype=np.int64))


def k1(q, wrapper):
    plan = tg.MergePlan.from_params(params(q), device="cpu")
    x = words(plan.n) % q
    return wrapper(x, x.flip(0), plan) if wrapper is hm.merge_u64_polymul_inv else wrapper(x, plan)


def k12(q, wrapper):
    plan = tg.RNSMergePlan.from_params([params(p) for p in (q, largest_ntt_prime(61, LOGN))],
                                       device="cpu")
    x = words(plan.n) % largest_ntt_prime(61, LOGN)  # canonical under both moduli
    midx = torch.tensor([0, 1], dtype=torch.int32)
    if wrapper is hr.rns_u64_polymul_inv:
        return wrapper(x, x.flip(0), plan, midx)
    return wrapper(x, plan, midx)


def large(q: int):
    """A LargePlan (A = 128 at logn 12, X^N - 1) of the largest prime below
    2^62, its q replaced by any other (from_spec itself refuses q >= 2^62)."""
    edge = largest_ntt_prime(62, LOGN)
    om = tg.ntt_root_pair(edge, LOGN)[0]
    lp = hml.LargePlan.from_spec(edge, LOGN, om, pow(om, edge - 2, edge), False, 1,
                                 device="cpu")
    return lp if q == edge else dataclasses.replace(lp, q=q)


def k7(q, inverse):
    lp = large(q)
    fn = hml.merge_u64_large_colinv if inverse else hml.merge_u64_large_colfwd
    return fn(words(lp.n), lp)


def k7_local(q, inverse):
    lp = large(q)
    return hml.col_phase_local(words(lp.n).view(2, lp.A, lp.B), lp, 0, 1, inverse)


def k13(q, inverse):
    edge = [largest_ntt_prime(62, LOGN), largest_ntt_prime(61, LOGN)]
    sp = hr.large_plan(tg.RNSMergePlan.from_params([params(p) for p in edge], device="cpu"))
    if q >= 1 << 62:  # a column plan whose ladder holds q (LargePlan refuses one)
        col = tg.RNSMergePlan.from_params([params(p, sp.first.col.logn) for p in (q, edge[1])],
                                          device="cpu")
        sp = dataclasses.replace(sp, col=col)
    fn = hr.rns_u64_large_colinv if inverse else hr.rns_u64_large_colfwd
    return fn(words(1 << LOGN), sp, torch.tensor([0, 1], dtype=torch.int32))


def k9(q, dtype=np.uint64):
    kp = hf.kernel_plan(tg.FourStepPlan.from_params(params(q, dtype=dtype, four=True),
                                                    device="cpu"))
    x = words(kp.n) % (1 << 32 if dtype == np.uint32 else 1 << 62)
    return (hf.fourstep_u64_col if dtype == np.uint64 else hf.fourstep_u32_col)(x, kp, False)


def k14(q):
    logn = 14  # the RNS 4-step's smallest
    ms = [params(p, logn, four=True) for p in (q, largest_ntt_prime(61, logn))]
    sp = hr.fourstep_plan(tg.RNSFourStepPlan.from_params(ms, device="cpu"))
    return hr.rns_fourstep_u64_col(words(1 << logn), sp, torch.tensor([0, 1], dtype=torch.int32),
                                   False)


def kmerge(q, bits):
    """kmerge_u32 (bits 30) or kmerge_u64 (bits 63) on a KernelMergePlan of
    the largest NTT prime below 2^bits, its q replaced by any other."""
    dtype = np.uint64 if bits == 63 else np.uint32
    edge = largest_ntt_prime(bits, LOGN)
    kp = hk.KernelMergePlan.from_params(params(edge, dtype=dtype), device="cpu")
    kp = kp if q == edge else dataclasses.replace(kp, q=q)
    x = words(kp.n) % (1 << 32 if dtype == np.uint32 else 1 << 62)
    return hk64.kmerge_u64(x, kp) if bits == 63 else hk.kmerge_u32(x, kp)


# wrapper -> (call(q), log2 of its bound, logn of the primes it takes)
CASES = {
    **{f"merge_u64_{w}": ((lambda fn: lambda q: k1(q, fn))(getattr(hm, f"merge_u64_{w}")), 62,
                          LOGN) for w in ("fwd", "inv", "polymul_inv")},
    **{f"rns_u64_{w}": ((lambda fn: lambda q: k12(q, fn))(getattr(hr, f"rns_u64_{w}")), 62,
                        LOGN) for w in ("fwd", "inv", "polymul_inv")},
    "merge_u64_large_colfwd": (lambda q: k7(q, False), 62, LOGN),
    "merge_u64_large_colinv": (lambda q: k7(q, True), 62, LOGN),
    "merge_u64_large_colfwd_local": (lambda q: k7_local(q, False), 62, LOGN),
    "merge_u64_large_colinv_local": (lambda q: k7_local(q, True), 62, LOGN),
    "rns_u64_large_colfwd": (lambda q: k13(q, False), 62, 7),
    "rns_u64_large_colinv": (lambda q: k13(q, True), 62, 7),
    "fourstep_u64_col": (k9, 62, LOGN),
    "fourstep_u32_col": (lambda q: k9(q, np.uint32), 30, LOGN),
    "rns_fourstep_u64_col": (k14, 62, 14),
    "kmerge_u32": (lambda q: kmerge(q, 30), 30, LOGN),
    "kmerge_u64": (lambda q: kmerge(q, 63), 63, LOGN),
}


@pytest.mark.parametrize("wrapper", sorted(CASES))
def test_column_wrapper_refuses_q_past_the_lazy_bound(wrapper, monkeypatch):
    """The largest NTT prime below twice the bound, which lies above it,
    is refused, even with K1-K3's and K12's `takes` widened to every plan;
    the largest below the bound runs."""
    call, bits, logn = CASES[wrapper]
    wide = largest_ntt_prime(bits + 1, logn)
    assert wide >= 1 << bits
    with monkeypatch.context() as mp:
        mp.setattr(hm, "takes", lambda plan: True)
        mp.setattr(hr, "takes", lambda plan: True)
        with pytest.raises(tg.NTTDispatchError, match=f"2\\^{bits}"):
            call(wide)
    y = call(largest_ntt_prime(bits, logn))
    assert y.dtype == torch.int64 and bool((y >= 0).all())


def test_kmerge_u64_takes_q_past_2_62():
    """K15's counterpart refuses nothing below 2^63: the "vpu" route and
    kmerge_u64 take OVER62 (a q just past 2^62, psi of order 2^13), which
    its canonical instance runs."""
    q, psi = 4611686018427494401, 795177494079348431
    psi = pow(psi, 1 << (12 - LOGN), q)
    p = tg.NTTParameters(LOGN, MINUS, np.uint64,
                         factors=tg.NTTFactors(tg.Modulus64(q), psi * psi % q, psi))
    plan = tg.MergePlan.from_params(p, device="cpu")
    assert hk64.route(plan) == "hopper-kmerge64"
    x = words(plan.n)
    y = tg.ntt_lanes(x, plan, use_pallas="vpu")
    assert torch.equal(tg.intt_lanes(y, plan, use_pallas="vpu"), x % q)
