"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same card, at
every logn the kernels take (u64 11-17, the u64 big rings 18-28, u32
8-25, the 4-step's 12-24 in both word sizes, the RNS kernels K12 at
11-17, K13 at 18-23, K14 at 14-23 and the stacked u32 kernels at 8-25
on cyclic and ordered schedules, the factored kernels K15 at 7-24 and
K17 at 7-25)
and both reduction polynomials, on any input word; wide and narrow moduli against the
golden NTTCPU, the big rings against the native oracle at 2^24 and the
4-step against NTT4StepCPU there; the RNS schedules and model
against the same entries on the CPU; the launch counters of the u32,
big-ring and 4-step routes; the wrappers' refusals; CUDA-event timing;
the distributed path: K7' on every shard of sp 1-8 at u64 2^20 and
2^24, the merge's per-rank tail plans, and the dist entries and models
at world size 1 on NCCL against the single-chip entries; the value
edges of the register-pass kernels (the largest NTT prime below 2^62 or
2^30) and operands that start at an odd word (K1-K3, K8, K12, and the
u32 RNS kernels on int32 and int64 lanes); the u32 RNS entries on int32
lanes against int64 lanes, and one traced int32 call's spans and device
operations; the whole-ring u32 kernels at logn 14-15 (a cluster of two
blocks a ring) on the 30-prime ladder at batches 1-480, and the device
kernels and the `passes` span attr of a u32 transform at logn 14-16; the
whole-ring u64 kernels at logn 11-15 (K12 on clusters of 1-8 blocks), the
device kernels and the `passes` attr of a u64 transform at logn 13-16, and
one traced u64 HE call's span and device operations; the benchmark's
2^27 ZK transforms through ntt_lanes / intt_lanes (the nested big ring)
against the plain composition, their route span's `passes` (3) and their
three device kernels.
Exact equality throughout.

This file imports neither jax nor gpuntt_tpu, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops import barrett as bo
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops.limb import from_numpy_u64, signed, to_numpy_u64
from gpuntt_tpu_torch.utils import kernel_bench
from gpuntt_tpu_torch.utils.kernel_bench import largest_ntt_prime
from gpuntt_tpu_torch.utils.timing import time_cuda

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

POLYS = [tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", [11, 12, 13, 14, 15, 16, 17])
def test_kernels_match_plain_on_card(card, logn, poly):
    p = tg.NTTParameters(logn, poly, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    rng = np.random.default_rng(logn)
    x = from_numpy_u64(rng.integers(0, 1 << 64, size=(3, p.n), dtype=np.uint64,
                                    endpoint=False), card)
    b = from_numpy_u64(rng.integers(0, p.modulus.value, size=(3, p.n),
                                    dtype=np.uint64), card)
    tracing.reset()
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


def _large_counts():
    return {k.name: (k.launches, k.plain_calls) for k in (*hm.KERNELS, *hml.KERNELS)
            if k.launches or k.plain_calls}


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn,batch", [(n, 1) for n in range(18, 29)] + [(20, 16)])
def test_large_kernels_match_plain_on_card(card, logn, batch, poly):
    """Every big ring at batch 1, and 2^20 x 16: K7 forward and inverse,
    and the whole transforms, which launch K8 (logn 27) or K1/K2 on the
    rows, against their plain versions on any u64 word; the round trip."""
    p = tg.NTTParameters(logn, poly, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    assert plan.fwd_table is None  # no N-entry table on this route
    lp = hml.large_plan(plan)
    x = from_numpy_u64(np.random.default_rng(logn).integers(
        0, 1 << 64, size=(batch, p.n), dtype=np.uint64, endpoint=False), card)
    tracing.reset()
    cf, ci = hml.merge_u64_large_colfwd(x, lp), hml.merge_u64_large_colinv(x, lp)
    torch.cuda.synchronize()
    assert _large_counts() == {hml.COLFWD.name: (1, 0), hml.COLINV.name: (1, 0)}
    assert torch.equal(cf, hml.colfwd_plain(x, lp))
    assert torch.equal(ci, hml.colinv_plain(x, lp))
    del cf, ci
    tracing.reset()
    fx = tg.ntt_lanes(x, plan)
    torch.cuda.synchronize()
    leaf = lp.nested or lp
    rows = hml.ROWMAT if leaf.row_kernel == "K8" else hm.FORWARD
    assert _large_counts() == {hml.COLFWD.name: (2 if lp.nested else 1, 0),
                               rows.name: (1, 0)}
    assert torch.equal(fx, hml.merge_u64_large_plain(x, lp))
    ix = tg.intt_lanes(fx, plan)
    assert torch.equal(ix, hml.merge_u64_large_plain(fx, lp, inverse=True))
    assert torch.equal(ix, bo.reduce_forced64(x, p.modulus.value))


@pytest.mark.parametrize("poly", POLYS)
def test_large_route_against_native_on_card(card, poly):
    """2^24 x 2 against the native oracle: ntt, intt and polymul (fused
    into K3's row inverse at this size)."""
    p = tg.NTTParameters(24, poly, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    gen = tg.NTTCPU(p)
    rng = np.random.default_rng(24)
    x = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64)
    y = rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64)
    tracing.reset()
    np.testing.assert_array_equal(tg.ntt(x, plan), gen.ntt(x))
    np.testing.assert_array_equal(tg.intt(x, plan), gen.intt(x))
    np.testing.assert_array_equal(tg.polymul(x, y, plan),
                                  gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))
    assert [k.launches for k in hm.KERNELS] == [3, 1, 1]


def test_staged_entries_on_card(card):
    """The JAX package's big-ring entries: the route's outputs at logn 24
    (u64 and u32, signed input and output), None below 24."""
    p = tg.NTTParameters(24, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    x = from_numpy_u64(np.random.default_rng(3).integers(
        0, p.modulus.value, size=(1, p.n), dtype=np.uint64), card)
    fx = tg.ntt_lanes(x, plan)
    assert torch.equal(td.staged_ntt_lanes(x, plan), fx)
    assert torch.equal(td.staged_ntt_lanes(fx, plan, inverse=True, signed_output=True),
                       bo.centered64(x, p.modulus.value))
    assert torch.equal(td.staged_ntt_lanes(bo.centered64(x, p.modulus.value), plan,
                                           signed_input=True), fx)
    assert torch.equal(td.staged_polymul_lanes(x, x, plan), tg.polymul_lanes(x, x, plan))
    p32, plan32 = _u32_plan(24, tg.ReductionPolynomial.X_N_plus, card)
    x32 = torch.from_numpy(np.random.default_rng(4).integers(
        0, p32.modulus.value, size=(1, p32.n), dtype=np.int64)).to(card)
    assert torch.equal(td.staged_ntt_lanes(x32, plan32), tg.ntt_lanes(x32, plan32))
    assert td.staged_polymul_lanes(x32, x32, plan32) is None  # u64 only, as in JAX
    p20 = tg.NTTParameters(20, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan20 = tg.MergePlan.from_params(p20, device=card)
    assert td.staged_ntt_lanes(x[:, :p20.n].contiguous(), plan20) is None


@pytest.mark.parametrize("logn", [18, 26])
def test_polynomial_multiplier_reaches_large_route_on_card(card, logn):
    """PolynomialMultiplier at a big ring: the fused product at logn 18,
    the unfused one at 26, both equal to the plain pipeline."""
    p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, np.uint64)
    model = tg.PolynomialMultiplier(p, device=card)
    assert {n for n, _ in model.named_buffers()} == {"anchor"}
    rng = np.random.default_rng(logn)
    a, b = (from_numpy_u64(rng.integers(0, p.modulus.value, size=(1, p.n),
                                        dtype=np.uint64), card) for _ in range(2))
    tracing.reset()
    out = model(a, b)
    torch.cuda.synchronize()
    lp = hml.large_plan(model.plan)
    fused = logn <= 25
    assert hm.POLYMUL_INVERSE.launches == int(fused)
    assert hm.INVERSE.launches == int(not fused)
    assert hml.COLFWD.launches == 2 and hml.COLINV.launches == 1
    fa, fb = (hml.merge_u64_large_plain(v, lp) for v in (a, b))
    prod = bo.barrett_mul64(fa, fb, lp.q, model.plan.bit, model.plan.mu)
    assert torch.equal(out, hml.merge_u64_large_plain(prod, lp, inverse=True))


def _factored(logn, poly, dtype, q):
    omega, psi = tg.ntt_root_pair(q, logn)
    mod = tg.Modulus64(q) if dtype == np.uint64 else tg.Modulus32(q)
    return tg.NTTParameters(logn, poly, dtype, factors=tg.NTTFactors(mod, omega, psi))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logb", range(1, 10))
def test_k8_value_edges_on_card(card, logb, poly, edge):
    """K8 against rowmat_plain at every row width (logB 1-9: one, two or
    three radix-8 passes), both directions, on any u64 word, at the
    61-bit pool prime or the largest NTT prime below 2^62 (4q just below
    2^64, the edge of the lazy butterflies); then the Stacked instance
    (rns_u64_large_rowmat) on a ladder of both, rows of each modulus."""
    pool = tg.NTTParameters(logb, poly, np.uint64)
    wide = _factored(logb, poly, np.uint64, largest_ntt_prime(62, 9))
    plan = tg.MergePlan.from_params(wide if edge else pool, device=card)
    shift = 12 - logb  # a row block's rows lie in one ring
    rng = np.random.default_rng(logb)
    x = from_numpy_u64(rng.integers(0, 1 << 64, size=(3 << shift, 1 << logb),
                                    dtype=np.uint64, endpoint=False), card)
    ladder = tg.RNSMergePlan.from_params([pool, wide] if edge else [wide, pool], device=card)
    midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    for inverse in (False, True):
        assert torch.equal(hml.merge_u64_large_rowmat(x, plan, inverse),
                           hml.rowmat_plain(x, plan, inverse))
        assert torch.equal(hr.rns_u64_large_rowmat(x, ladder, midx, shift, inverse),
                           hr.rowmat_plain(x, ladder, midx, shift, inverse))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(11, 18))
def test_merge_value_edges_on_card(card, logn, poly, edge):
    """K1-K3 against their plain versions at every logn 11-17 (every
    (log A, log B) split of the route's register passes), on any u64 word,
    at the 60-bit pool prime or the largest NTT prime below 2^62 (4q just
    below 2^64, the edge of the lazy butterflies); then K12 on a ladder of
    both, a schedule entry a ring and one for two rings."""
    pool = tg.NTTParameters(logn, poly, np.uint64)
    wide = _factored(logn, poly, np.uint64, largest_ntt_prime(62, 17))
    plan = tg.MergePlan.from_params(wide if edge else pool, device=card)
    rng = np.random.default_rng(logn)
    x = from_numpy_u64(rng.integers(0, 1 << 64, size=(4, 1 << logn), dtype=np.uint64,
                                    endpoint=False), card)
    fx = hm.merge_u64_fwd(x, plan)
    assert torch.equal(fx, hm.merge_u64_fwd_plain(x, plan))
    assert torch.equal(hm.merge_u64_inv(x, plan), hm.merge_u64_inv_plain(x, plan))
    fb = fx.flip(0).contiguous()
    assert torch.equal(hm.merge_u64_polymul_inv(fx, fb, plan),
                       hm.merge_u64_polymul_inv_plain(fx, fb, plan))
    ladder = tg.RNSMergePlan.from_params([pool, wide] if edge else [wide, pool], device=card)
    for midx, shift in (([1, 0, 1, 1], 0), ([1, 0], 1)):
        m = torch.tensor(midx, dtype=torch.int32, device=card)
        fx = hr.rns_u64_fwd(x, ladder, m, shift)
        assert torch.equal(fx, hr.rns_u64_fwd_plain(x, ladder, m, shift))
        assert torch.equal(hr.rns_u64_inv(x, ladder, m, shift),
                           hr.rns_u64_inv_plain(x, ladder, m, shift))
        fb = hr.rns_u64_fwd_plain(x.flip(0).contiguous(), ladder, m, shift)
        assert torch.equal(hr.rns_u64_polymul_inv(fx, fb, ladder, m, shift),
                           hr.rns_u64_polymul_inv_plain(fx, fb, ladder, m, shift))


@pytest.mark.parametrize("logn", [11, 14, 16, 17])
def test_odd_word_views_on_card(card, logn):
    """F4: an operand that starts at an odd word, flat[1:1 + rows * B].view(rows, B),
    through K8 (merge_u64_large_rowmat, rows of 2^(logn - 8)), K1-K3 and
    K12: the kernels take 8-byte accesses where 16-byte ones would be
    misaligned, and agree with their plain versions."""
    p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    rows = 3
    flat = from_numpy_u64(np.random.default_rng(logn).integers(
        0, 1 << 64, size=(rows << logn) + 2, dtype=np.uint64), card)
    x = flat[1:1 + (rows << logn)].view(rows, 1 << logn)
    assert x.data_ptr() % 16 == 8 and x.is_contiguous()
    xc = x.clone()
    logb = logn - 8
    rp = tg.MergePlan.from_params(tg.NTTParameters(logb, tg.ReductionPolynomial.X_N_minus,
                                                   np.uint64), device=card)
    for inverse in (False, True):
        r = flat[1:1 + (rows << logn)].view(-1, 1 << logb)
        assert torch.equal(hml.merge_u64_large_rowmat(r, rp, inverse),
                           hml.rowmat_plain(xc.view(-1, 1 << logb), rp, inverse))
    fx = hm.merge_u64_fwd(x, plan)
    assert torch.equal(fx, hm.merge_u64_fwd_plain(xc, plan))
    assert torch.equal(hm.merge_u64_inv(x, plan), hm.merge_u64_inv_plain(xc, plan))
    fflat = torch.zeros_like(flat)
    fo = fflat[1:1 + (rows << logn)].view(rows, 1 << logn)
    fo.copy_(fx.flip(0))
    assert torch.equal(hm.merge_u64_polymul_inv(fx, fo, plan),
                       hm.merge_u64_polymul_inv_plain(fx, fo.clone(), plan))
    ladder = tg.RNSMergePlan.from_params(_rns_members(logn, tg.ReductionPolynomial.X_N_plus),
                                         device=card)
    m = torch.tensor([2, 0, 1], dtype=torch.int32, device=card)
    assert torch.equal(hr.rns_u64_fwd(x, ladder, m), hr.rns_u64_fwd_plain(xc, ladder, m))
    assert torch.equal(hr.rns_u64_inv(x, ladder, m), hr.rns_u64_inv_plain(xc, ladder, m))
    fr = hr.rns_u64_fwd_plain(xc, ladder, m)
    fo.copy_(hr.rns_u64_fwd_plain(xc.flip(0).contiguous(), ladder, m))
    assert torch.equal(hr.rns_u64_polymul_inv(fr, fo, ladder, m),
                       hr.rns_u64_polymul_inv_plain(fr, fo.clone(), ladder, m))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("loga", range(1, 10))
def test_k7_value_edges_on_card(card, loga, poly):
    """K7, K7' (both shards of sp = 2) and K13-col against their plain
    versions at every column count (logA 1-9: one, two or three radix-8
    passes; 2^14-word rings, the full tile, and for K13-col rows of 512,
    which a stacked plan takes at every logA), both directions, on any u64
    word, at the largest NTT prime below 2^62 and a 61-bit one."""
    edge = (largest_ntt_prime(62, 18), largest_ntt_prime(61, 18))
    x = from_numpy_u64(np.random.default_rng(loga).integers(
        0, 1 << 64, size=(3, 1 << 14), dtype=np.uint64), card)
    for q in edge:
        lp = kernel_bench._large(q, 14, poly, loga, card, tile=1 << (13 - loga))
        assert torch.equal(hml.merge_u64_large_colfwd(x, lp), hml.colfwd_plain(x, lp))
        assert torch.equal(hml.merge_u64_large_colinv(x, lp), hml.colinv_plain(x, lp))
        for shard in (0, 1):
            xs = x.view(3, lp.A, 2, lp.B // 2)[:, :, shard].contiguous()
            for inverse in (False, True):
                assert torch.equal(hml.col_phase_local(xs, lp, shard, 2, inverse),
                                   hml.col_phase_local_plain(xs, lp, shard, 2, inverse))
    sp = hr.RNSColumnPlan.from_members([kernel_bench._large(q, loga + 9, poly, loga, card)
                                        for q in edge])
    midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    x = from_numpy_u64(np.random.default_rng(loga).integers(
        0, 1 << 64, size=(3, 1 << (loga + 9)), dtype=np.uint64), card)
    assert torch.equal(hr.rns_u64_large_colfwd(x, sp, midx), hr.colfwd_plain(x, sp, midx))
    assert torch.equal(hr.rns_u64_large_colinv(x, sp, midx), hr.colinv_plain(x, sp, midx))


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("log1", range(1, 10))
def test_k9_value_edges_on_card(card, log1, poly, dtype):
    """K9 (with K14 on a ladder) and K11's column twin against their plain
    versions at every n1 (log n1 1-9), both directions, on any input word,
    at the largest NTT prime below 2^62 (u64) or 2^30 (u32) and a smaller
    one."""
    is64 = dtype == np.uint64
    bits = 62 if is64 else 30
    edge = (largest_ntt_prime(bits, 14), largest_ntt_prime(bits - 1, 14))
    x = from_numpy_u64(np.random.default_rng(log1).integers(
        0, 1 << (64 if is64 else 32), size=(3, 1 << 14), dtype=np.uint64), card)
    col = hf.fourstep_u64_col if is64 else hf.fourstep_u32_col
    kps = [kernel_bench._fourstep(q, 14, poly, log1, is64, card) for q in edge]
    midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=card)
    for inverse in (False, True):
        for kp in kps:
            assert torch.equal(col(x, kp, inverse), hf.col_plain(x, kp, inverse))
        if is64:
            sp = hr.RNSColumnPlan.from_members(kps)
            assert torch.equal(hr.rns_fourstep_u64_col(x, sp, midx, inverse),
                               hr.col4_plain(x, sp, midx, inverse))


@pytest.mark.parametrize("logn", range(8, 26))
def test_u32_lazy_edge_on_card(card, logn):
    """merge_u32.cu at the largest NTT prime below 2^30 of each logn (4q
    just below 2^32, the edge of the lazy butterflies), on any u32 word:
    forward, inverse and the fused polymul inverse of a ladder holding it
    (rns_u32_polymul_inverse), against the plain versions."""
    poly = POLYS[logn % 2]
    q = largest_ntt_prime(30, logn)
    p = _factored(logn, poly, np.uint32, q)
    plan = tg.MergePlan.from_params(p, device=card)
    batch = max(1, (1 << 21) >> logn)
    rng = np.random.default_rng(logn)
    x, b = (torch.from_numpy(rng.integers(0, 1 << 32, size=(batch, p.n), dtype=np.int64)).to(card)
            for _ in range(2))
    assert torch.equal(hm32.merge_u32_fwd(x, plan), hm32.merge_u32_fwd_plain(x, plan))
    assert torch.equal(hm32.merge_u32_inv(x, plan), hm32.merge_u32_inv_plain(x, plan))
    members = [p] + ([_factored(logn, poly, np.uint32, largest_ntt_prime(29, logn))]
                     if logn < 25 else [])
    ladder = tg.RNSMergePlan.from_params(members, device=card)
    midx = (torch.arange(batch, dtype=torch.int32, device=card) % len(members)).flip(0)
    assert torch.equal(hr32.rns_u32_polymul_inv(x, b, ladder, midx),
                       hr32.rns_u32_polymul_inv_plain(x, b, ladder, midx))


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
    tracing.reset()
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
        tracing.reset()
        np.testing.assert_array_equal(tg.ntt(x, plan), gen.ntt(x))
        np.testing.assert_array_equal(tg.intt(x, plan), gen.intt(x))
        np.testing.assert_array_equal(tg.polymul(x, y, plan),
                                      gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))
        assert hm32.FORWARD["K4"].launches == 3 and hm32.INVERSE["K4"].launches == 2
        assert sum(k.plain_calls for k in hm32.KERNELS) == 0


def test_u32_route_runs_k4_k5_k6_on_card(card):
    """ntt_lanes / intt_lanes at 2^16, 2^17 and 2^20 launch the
    counterparts of K4, K5 and K6 once each, and no plain version."""
    tracing.reset()
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


def _fourstep_plan(logn, poly, dtype, card):
    p = tg.NTTParameters4Step(logn, poly, dtype)
    return p, tg.FourStepPlan.from_params(p, device=card)


def _words(shape, is64, seed, card):
    """Any input word: full 64-bit patterns, or values below 2^32 (u32)."""
    x = np.random.default_rng(seed).integers(0, 1 << (64 if is64 else 32), size=shape,
                                             dtype=np.uint64, endpoint=False)
    return from_numpy_u64(x, card)


def _fourstep_counts():
    return {k.name: (k.launches, k.plain_calls)
            for k in (*hf.KERNELS, *hm.KERNELS, *hm32.KERNELS) if k.launches or k.plain_calls}


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(12, 25))
def test_fourstep_kernels_match_plain_on_card(card, logn, poly, dtype):
    """K9 / K11's column twin in both directions, the rows (K10, K11's
    row twin, or the merge kernels above 512 words) and the whole
    transforms, against their plain versions, at every logn of
    MATRIX_DIMENSIONS, batch 1, on any input word."""
    p, plan = _fourstep_plan(logn, poly, dtype, card)
    kp = hf.kernel_plan(plan)
    is64 = dtype == np.uint64
    col = hf.fourstep_u64_col if is64 else hf.fourstep_u32_col
    x = _words((1, p.n), is64, logn, card)
    tracing.reset()
    for inverse in (False, True):
        y = col(x, kp, inverse)
        assert torch.equal(y, hf.col_plain(x, kp, inverse)), inverse
        if kp.n2 <= hf.ROW_MAT_MAX:
            r = y.view(-1, kp.n2)
            row = hf.fourstep_u64_row if is64 else hf.fourstep_u32_row
            plain = hml.rowmat_plain if is64 else hf.row32_plain
            assert torch.equal(row(r, kp.rows, inverse), plain(r, kp.rows, inverse))
    torch.cuda.synchronize()
    stats = [hf.COL64 if is64 else hf.COL32]
    if kp.n2 <= hf.ROW_MAT_MAX:
        stats.append(hf.ROW64 if is64 else hf.ROW32)
    assert _fourstep_counts() == {s.name: (2, 0) for s in stats}
    for inverse in (False, True):
        assert torch.equal(hf.fourstep(x, kp, inverse), hf.fourstep_plain(x, kp, inverse))


@pytest.mark.parametrize("poly", POLYS)
def test_fourstep_entries_against_golden_on_card(card, poly):
    """u64 2^24 (256 x 65536): the four entries through the public
    functions, the _full pair against NTT4StepCPU (the native oracle),
    the lanes pair against the plain composition; K9 and K1/K2 ran."""
    p, plan = _fourstep_plan(24, poly, np.uint64, card)
    x_np = np.random.default_rng(24).integers(0, p.modulus.value, size=(1, p.n),
                                              dtype=np.uint64)
    x = from_numpy_u64(x_np, card)
    gen = tg.NTT4StepCPU(p)
    tracing.reset()
    fx = tg.fourstep_ntt_full(x, plan)
    ix = tg.fourstep_intt_full(x, plan)
    torch.cuda.synchronize()
    assert _fourstep_counts() == {hf.COL64.name: (2, 0), hm.FORWARD.name: (1, 0),
                                  hm.INVERSE.name: (1, 0)}
    np.testing.assert_array_equal(to_numpy_u64(fx[0]), gen.ntt(x_np[0]))
    np.testing.assert_array_equal(to_numpy_u64(ix[0]), gen.intt(x_np[0]))
    assert torch.equal(tg.fourstep_intt_full(fx, plan), x)
    kp = hf.kernel_plan(plan)
    assert torch.equal(tg.fourstep_ntt_lanes(x, plan), hf.fourstep_plain(x, kp))
    assert torch.equal(tg.fourstep_intt_lanes(x, plan), hf.fourstep_plain(x, kp, True))
    assert "w" not in plan._lazy  # the kernel route built no W table


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_fourstep_he_width_on_card(card, dtype):
    """2^16 x 128 (128 x 512: rows on K10 / K11's row twin): the lanes
    entries against the plain composition on every row, and the round
    trip through the _full entries."""
    p, plan = _fourstep_plan(16, tg.ReductionPolynomial.X_N_minus, dtype, card)
    x = torch.from_numpy(np.random.default_rng(16).integers(
        0, p.modulus.value, size=(128, p.n), dtype=np.int64)).to(card)
    kp = hf.kernel_plan(plan)
    tracing.reset()
    fx = tg.fourstep_ntt_lanes(x, plan)
    ix = tg.fourstep_intt_lanes(fx, plan)
    torch.cuda.synchronize()
    col, row = (hf.COL64, hf.ROW64) if kp.is64 else (hf.COL32, hf.ROW32)
    assert _fourstep_counts() == {col.name: (2, 0), row.name: (2, 0)}
    assert torch.equal(fx, hf.fourstep_plain(x, kp))
    assert torch.equal(ix, hf.fourstep_plain(fx, kp, True))
    assert torch.equal(tg.fourstep_intt_full(tg.fourstep_ntt_full(x, plan), plan), x)


def test_fourstep_wrappers_refuse_on_card(card):
    p, plan = _fourstep_plan(12, tg.ReductionPolynomial.X_N_plus, np.uint64, card)
    kp = hf.kernel_plan(plan)
    x = torch.zeros((2, p.n), dtype=torch.int64, device=card)
    with pytest.raises(tg.NTTDispatchError):
        hf.fourstep_u64_col(x.cpu(), kp, False)
    with pytest.raises(tg.NTTDispatchError):
        hf.fourstep_u64_col(x.to(torch.int32), kp, False)
    with pytest.raises(tg.NTTDispatchError):
        hf.fourstep_u32_col(x, kp, False)
    with pytest.raises(tg.NTTDispatchError):
        hf.fourstep_u64_row(x.view(-1, kp.n2).t(), kp.rows, True)


def test_time_cuda(card):
    x = torch.ones(1 << 20, device=card)
    ms, spread = time_cuda(lambda: x.mul_(1.0), warmup=1, repeats=5, inner=3)
    assert ms > 0 and spread >= 0


# ------------------------------------------------------------------- RNS


def _rns_members(logn, poly, mc=3, four=False):
    params = tg.NTTParameters4Step if four else tg.NTTParameters
    out = []
    for q in tg.find_ntt_primes(59, logn, mc):
        omega, psi = tg.ntt_root_pair(q, logn)
        out.append(params(logn, poly, np.uint64,
                          factors=tg.NTTFactors(tg.Modulus64(q), omega, psi)))
    return out


# one entry per polynomial of a batch of 4: the cyclic ladder, and an order
SCHEDULES = {"cyclic": [0, 1, 2, 0], "ordered": [2, 0, 2, 1]}


def _rns_counts():
    return {k.name: (k.launches, k.plain_calls) for k in hr.KERNELS
            if k.launches or k.plain_calls}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(11, 18))
def test_rns_k12_matches_plain_on_card(card, logn, poly, schedule):
    """K12 forward, inverse and fused polymul inverse, ladder 3, on any u64
    word, with one schedule entry per row and per ring of two rows."""
    plan = tg.RNSMergePlan.from_params(_rns_members(logn, poly), device=card)
    midx = torch.tensor(SCHEDULES[schedule], dtype=torch.int32, device=card)
    for shift in (0, 1):
        x = _words((4 << shift, plan.n), True, logn + shift, card)
        tracing.reset()
        fx = hr.rns_u64_fwd(x, plan, midx, shift)
        fb = hr.rns_u64_fwd(x.flip(0), plan, midx, shift)
        ix = hr.rns_u64_inv(x, plan, midx, shift)
        px = hr.rns_u64_polymul_inv(fx, fb, plan, midx, shift)
        torch.cuda.synchronize()
        assert _rns_counts() == {hr.FORWARD.name: (2, 0), hr.INVERSE.name: (1, 0),
                                 hr.POLYMUL_INVERSE.name: (1, 0)}
        assert torch.equal(fx, hr.rns_u64_fwd_plain(x, plan, midx, shift))
        assert torch.equal(ix, hr.rns_u64_inv_plain(x, plan, midx, shift))
        assert torch.equal(px, hr.rns_u64_polymul_inv_plain(fx, fb, plan, midx, shift))


@pytest.mark.parametrize("rows", [30, 240])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(12, 18))
def test_rns_u64_polymul_matches_the_wrappers_on_card(card, logn, poly, rows):
    """K12's product in one C call (hopper_rns.rns_u64_polymul, prepared
    by dispatch's route on its first call and found on the next)
    bit-identical to the three wrappers it replaces (forward, forward,
    fused inverse), ladder 5 on the cyclic schedule, on any u64 word and
    a non-contiguous operand; the same launch counts."""
    plan = tg.RNSMergePlan.from_params(_rns_members(logn, poly, 5), device=card)
    order = np.arange(rows) % 5
    midx = torch.tensor(order, dtype=torch.int32, device=card)
    a = _words((rows, plan.n), True, logn, card)
    b = _words((rows, 2 * plan.n), True, logn + 1, card)[:, plan.n:]
    assert not b.is_contiguous()
    want = hr.rns_u64_polymul_inv(hr.rns_u64_fwd(a, plan, midx),
                                  hr.rns_u64_fwd(b.contiguous(), plan, midx), plan, midx)
    tracing.reset()
    got = [td.rns_polymul_lanes(a, b, plan, order) for _ in range(2)]
    got.append(hr.rns_u64_polymul(a, b, hr.prepare(plan, midx)))
    torch.cuda.synchronize()
    assert _rns_counts() == {hr.FORWARD.name: (6, 0), hr.POLYMUL_INVERSE.name: (3, 0)}
    assert (tracing.COUNTERS["schedule.miss"], tracing.COUNTERS["schedule.hit"]) == (1, 1)
    assert all(torch.equal(y, want) for y in got)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(18, 24))
def test_rns_k13_matches_plain_on_card(card, logn, poly, schedule):
    """K13's column kernels, the compositions (rows on K12) and the fused
    polymul, ladder 3, batch 4, against their plain versions; the route
    through dispatch launches them and builds no N-entry table."""
    plan = tg.RNSMergePlan.from_params(_rns_members(logn, poly), device=card)
    sp = hr.large_plan(plan)
    order = SCHEDULES[schedule]
    midx = torch.tensor(order, dtype=torch.int32, device=card)
    x = _words((4, plan.n), True, logn, card)
    tracing.reset()
    assert torch.equal(hr.rns_u64_large_colfwd(x, sp, midx), hr.colfwd_plain(x, sp, midx))
    assert torch.equal(hr.rns_u64_large_colinv(x, sp, midx), hr.colinv_plain(x, sp, midx))
    fx = td.ntt_rns_lanes(x, plan, order)
    ix = td.intt_rns_lanes(x, plan, order)
    torch.cuda.synchronize()
    assert _rns_counts() == {hr.LARGE_COLFWD.name: (2, 0), hr.LARGE_COLINV.name: (2, 0),
                             hr.FORWARD.name: (1, 0), hr.INVERSE.name: (1, 0)}
    assert torch.equal(fx, hr.rns_u64_large_plain(x, sp, midx))
    assert torch.equal(ix, hr.rns_u64_large_plain(x, sp, midx, inverse=True))
    fb = fx.flip(0).contiguous()
    assert torch.equal(hr.rns_u64_large_polymul_inv(fx, fb, sp, midx),
                       hr.rns_u64_large_polymul_inv_plain(fx, fb, sp, midx))
    assert plan.fwd_tables is None and all(m.fwd_table is None for m in plan.members)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(14, 24))
def test_rns_k14_matches_plain_on_card(card, logn, poly, schedule):
    """K14 in both directions, its rows (K13's row kernel at 512 words,
    K12 above) and the whole transforms through the public entries,
    ladder 3, batch 4, against the plain versions; no W table is built."""
    plan = tg.RNSFourStepPlan.from_params(_rns_members(logn, poly, four=True), device=card)
    sp = hr.fourstep_plan(plan)
    order = SCHEDULES[schedule]
    midx = torch.tensor(order, dtype=torch.int32, device=card)
    x = _words((4, plan.n), True, logn, card)
    tracing.reset()
    for inverse in (False, True):
        assert torch.equal(hr.rns_fourstep_u64_col(x, sp, midx, inverse),
                           hr.col4_plain(x, sp, midx, inverse))
        got = (tg.rns_fourstep_intt_lanes if inverse else tg.rns_fourstep_ntt_lanes)(
            x, plan, order)
        assert torch.equal(got, hr.rns_fourstep_plain(x, sp, midx, inverse)), inverse
    torch.cuda.synchronize()
    rows = ({hr.LARGE_ROWMAT.name: (2, 0)} if sp.first.n2 <= 512 else
            {hr.FORWARD.name: (1, 0), hr.INVERSE.name: (1, 0)})
    assert _rns_counts() == {hr.FOURSTEP_COL.name: (4, 0), **rows}
    assert all("w" not in m._lazy for m in plan.members)


def test_rns_schedules_on_card(card):
    """The ordered entries on the card against the same entries on the
    CPU: an out-of-range order (read as jnp reads it) and a repeated
    poly_ordered row (the last occurrence wins), at logn 12 (K12) and 14
    (K12; the 4-step on K14), both polynomials."""
    for logn in (12, 14):
        for poly in POLYS:
            members = _rns_members(logn, poly)
            plan = tg.RNSMergePlan.from_params(members, device=card)
            cpu = tg.RNSMergePlan.from_params(members, device="cpu")
            x = np.random.default_rng(logn).integers(0, min(plan.qs), size=(4, plan.n),
                                                     dtype=np.uint64)
            tracing.reset()
            for order in ([2, 0, 1], [5, -1, 0]):
                for name in ("ntt_modulus_ordered", "intt_modulus_ordered"):
                    fn = getattr(tg, name)
                    np.testing.assert_array_equal(fn(x, plan, order), fn(x, cpu, order))
            for name in ("ntt_poly_ordered", "intt_poly_ordered"):
                fn = getattr(tg, name)
                np.testing.assert_array_equal(fn(x, plan, [2, 0, 2], batch_size=3),
                                              fn(x, cpu, [2, 0, 2], batch_size=3))
            np.testing.assert_array_equal(tg.rns_polymul(x, x, plan, order=[1, 2, 0]),
                                          tg.rns_polymul(x, x, cpu, order=[1, 2, 0]))
            assert [k.launches for k in hr.KERNELS[:3]] == [5, 3, 1]
    plan4 = tg.RNSFourStepPlan.from_params(_rns_members(14, POLYS[0], four=True), device=card)
    cpu4 = tg.RNSFourStepPlan.from_params(_rns_members(14, POLYS[0], four=True), device="cpu")
    x = _words((3, plan4.n), True, 7, card)
    for fn in (tg.rns_fourstep_ntt_full, tg.rns_fourstep_intt_full):
        assert torch.equal(fn(x, plan4, [2, -1, 5]).cpu(), fn(x.cpu(), cpu4, [2, -1, 5]))


def test_rns_model_on_card(card):
    """RNSPolynomialMultiplier at 2^16 (K12) and 2^18 (K13), ladder 3, two
    residue stacks: equal to the plain pipeline, and its buffers follow
    the module."""
    for logn in (16, 18):
        members = _rns_members(logn, POLYS[1])
        model = tg.RNSPolynomialMultiplier(members, device=card)
        rng = np.random.default_rng(logn)
        a, b = (torch.from_numpy(rng.integers(0, min(model.qs), size=(2, 3, 1 << logn),
                                              dtype=np.int64)).to(card) for _ in range(2))
        tracing.reset()
        out = model(a, b)
        torch.cuda.synchronize()
        assert hr.POLYMUL_INVERSE.launches == 1 and hr.FORWARD.launches == 2
        cpu = tg.RNSMergePlan.from_params(members, device="cpu")
        want = tg.rns_polymul(to_numpy_u64(a.reshape(6, -1)), to_numpy_u64(b.reshape(6, -1)),
                              cpu)
        np.testing.assert_array_equal(to_numpy_u64(out.reshape(6, -1)), want)
        assert model.cpu().plan.device.type == "cpu"


def test_rns_wrappers_refuse_on_card(card):
    plan = tg.RNSMergePlan.from_params(_rns_members(12, POLYS[1]), device=card)
    x = torch.zeros((2, plan.n), dtype=torch.int64, device=card)
    midx = torch.tensor([1, 0], dtype=torch.int32, device=card)
    with pytest.raises(tg.NTTDispatchError):
        hr.rns_u64_fwd(x.cpu(), plan, midx)
    with pytest.raises(tg.NTTDispatchError):
        hr.rns_u64_fwd(x, plan, midx.cpu())
    with pytest.raises(tg.NTTDispatchError):
        hr.rns_u64_fwd(x, plan, midx.long())
    with pytest.raises(tg.NTTDispatchError):
        hr.rns_u64_inv(x.reshape(-1, 2).t(), plan, midx)


def _u32_ladder(logn, poly, mc=3):
    """Up to `mc` of the largest primes q < 2^30 with a 2N-th root of
    unity: three at logn 8-23, [469762049, 167772161] at 24 and
    [469762049] at 25, where no other q < 2^30 is left."""
    step, qs = 2 << logn, []
    k = ((1 << 30) - 1) // step
    while len(qs) < mc and k > 0:
        if tg.is_prime_u64(k * step + 1):
            qs.append(k * step + 1)
        k -= 1
    out = []
    for q in qs:
        omega, psi = tg.ntt_root_pair(q, logn)
        out.append(tg.NTTParameters(logn, poly, np.uint32,
                                    factors=tg.NTTFactors(tg.Modulus32(q), omega, psi)))
    return out


def _rns32_counts():
    return {k.name: (k.launches, k.plain_calls) for k in hr32.KERNELS
            if k.launches or k.plain_calls}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(8, 26))
def test_rns32_kernels_match_plain_on_card(card, logn, poly, schedule):
    """The stacked u32 kernels (K16's counterpart up to logn 17, K6's
    per-modulus function above) forward, inverse and fused polymul
    inverse on any u32 word, with one schedule entry per row and per ring
    of two rows; then ntt_rns_lanes, intt_rns_lanes and rns_polymul_lanes
    through dispatch, which launch them (at logn 14-15 the product as its
    one fused launch) and no plain version."""
    plan = tg.RNSMergePlan.from_params(_u32_ladder(logn, poly), device=card)
    order = [m % plan.mod_count for m in SCHEDULES[schedule]]
    midx = torch.tensor(order, dtype=torch.int32, device=card)
    k = hr32.tpu_kernel(logn)
    fwd, inv, pinv = (hr32.FORWARD[k].name, hr32.INVERSE[k].name,
                      hr32.POLYMUL_INVERSE[k].name)
    for shift in (0, 1):
        x = _words((4 << shift, plan.n), False, logn + shift, card)
        tracing.reset()
        fx = hr32.rns_u32_fwd(x, plan, midx, shift)
        fb = hr32.rns_u32_fwd(x.flip(0), plan, midx, shift)
        ix = hr32.rns_u32_inv(x, plan, midx, shift)
        px = hr32.rns_u32_polymul_inv(fx, fb, plan, midx, shift)
        torch.cuda.synchronize()
        assert _rns32_counts() == {fwd: (2, 0), inv: (1, 0), pinv: (1, 0)}
        assert torch.equal(fx, hr32.rns_u32_fwd_plain(x, plan, midx, shift))
        assert torch.equal(ix, hr32.rns_u32_inv_plain(x, plan, midx, shift))
        assert torch.equal(px, hr32.rns_u32_polymul_inv_plain(fx, fb, plan, midx, shift))
    x = x[:4] % min(plan.qs)
    tracing.reset()
    fx = td.ntt_rns_lanes(x, plan, order)
    assert torch.equal(td.intt_rns_lanes(fx, plan, order), x)
    px = td.rns_polymul_lanes(x, x.flip(0), plan, order)
    torch.cuda.synchronize()
    assert _rns32_counts() == ({fwd: (1, 0), inv: (1, 0), hr32.POLYMUL.name: (1, 0)}
                               if hr32.fuses(plan) else {fwd: (3, 0), inv: (1, 0), pinv: (1, 0)})
    assert torch.equal(px, hr32.rns_u32_polymul_inv_plain(
        fx, hr32.rns_u32_fwd_plain(x.flip(0).contiguous(), plan, midx), plan, midx))


def test_rns32_model_and_schedules_on_card(card):
    """RNSPolynomialMultiplier on a u32 ladder of 3 at 2^12 and 2^18, and
    the ordered entries at logn 8 and 12, against the same calls on the
    CPU."""
    for logn in (12, 18):
        members = _u32_ladder(logn, POLYS[1])
        model = tg.RNSPolynomialMultiplier(members, device=card)
        rng = np.random.default_rng(logn)
        a, b = (torch.from_numpy(rng.integers(0, min(model.qs), size=(2, 3, 1 << logn),
                                              dtype=np.int64)).to(card) for _ in range(2))
        tracing.reset()
        out = model(a, b)
        torch.cuda.synchronize()
        k = hr32.tpu_kernel(logn)
        assert _rns32_counts() == {hr32.FORWARD[k].name: (2, 0),
                                   hr32.POLYMUL_INVERSE[k].name: (1, 0)}
        cpu = tg.RNSPolynomialMultiplier(members, device="cpu")
        assert torch.equal(out.cpu(), cpu(a.cpu(), b.cpu()))
    for logn in (8, 12):
        members = _u32_ladder(logn, POLYS[0])
        plan = tg.RNSMergePlan.from_params(members, device=card)
        cpu = tg.RNSMergePlan.from_params(members, device="cpu")
        x = np.random.default_rng(logn).integers(0, min(plan.qs), size=(32, plan.n),
                                                 dtype=np.uint64).astype(np.uint32)
        for order in ([2, 0, 1], [5, -1, 0]):
            for name in ("ntt_modulus_ordered", "intt_modulus_ordered"):
                fn = getattr(tg, name)
                np.testing.assert_array_equal(fn(x, plan, order), fn(x, cpu, order))
        for name in ("ntt_poly_ordered", "intt_poly_ordered"):
            fn = getattr(tg, name)
            np.testing.assert_array_equal(fn(x, plan, [2, 0, 2, 31], batch_size=4),
                                          fn(x, cpu, [2, 0, 2, 31], batch_size=4))


def test_rns32_wrappers_refuse_on_card(card):
    plan = tg.RNSMergePlan.from_params(_u32_ladder(12, POLYS[1]), device=card)
    x = torch.zeros((2, plan.n), dtype=torch.int64, device=card)
    midx = torch.tensor([1, 0], dtype=torch.int32, device=card)
    for bad_x, bad_m in ((x.cpu(), midx), (x, midx.cpu()), (x, midx.long()),
                         (x.reshape(-1, 2).t(), midx)):
        with pytest.raises(tg.NTTDispatchError):
            hr32.rns_u32_fwd(bad_x, plan, bad_m)


def _u32_words_ladder(logn, count=30, poly=tg.ReductionPolynomial.X_N_plus):
    """`count` 30-bit primes with a 2N-th root of unity (the port's search,
    as portbench's he_std128_n15_u32 finds its 30 at logn 15), X^N + 1 or
    `poly`."""
    out = []
    for q in tg.find_ntt_primes(30, logn, count):
        omega, psi = tg.ntt_root_pair(q, logn)
        out.append(tg.NTTParameters(logn, poly, np.uint32,
                                    factors=tg.NTTFactors(tg.Modulus32(q), omega, psi)))
    return out


def _residues(plan, rows, seed, card):
    """(rows, N) int64 lanes on the card, row r canonical under modulus r % L."""
    q = torch.tensor(plan.qs, device=card)[torch.arange(rows, device=card) % plan.mod_count]
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return torch.randint(0, 1 << 62, (rows, plan.n), generator=gen, device=card) % q[:, None]


@pytest.mark.parametrize("rows", [60, 480])
@pytest.mark.parametrize("logn", [*range(8, 18), 18])
def test_rns32_int32_lanes_on_card(card, logn, rows):
    """A ladder of 30 primes of 30 bits (the u32 HE deployment's shape):
    ntt_rns_lanes, intt_rns_lanes and rns_polymul_lanes on int32 lanes
    equal the int64 lanes' results narrowed, bit for bit, through the
    4-byte-word kernels (K16 up to logn 17, K6's function at 18; the
    product at logn 14-15 in one fused launch) and no plain version."""
    plan = tg.RNSMergePlan.from_params(_u32_words_ladder(logn), device=card)
    mod_idx = np.arange(rows) % plan.mod_count
    a, b = _residues(plan, rows, logn, card), _residues(plan, rows, logn + 1, card)
    a32, b32 = a.int(), b.int()
    for fn in (td.ntt_rns_lanes, td.intt_rns_lanes):
        got = fn(a32, plan, mod_idx)
        assert got.dtype == torch.int32 and torch.equal(got, fn(a, plan, mod_idx).int())
    tracing.reset()
    got = td.rns_polymul_lanes(a32, b32, plan, mod_idx)
    torch.cuda.synchronize()
    k = hr32.tpu_kernel(logn)
    assert _rns32_counts() == ({hr32.POLYMUL.name: (1, 0)} if hr32.fuses(plan) else
                               {hr32.FORWARD[k].name: (2, 0), hr32.POLYMUL_INVERSE[k].name: (1, 0)})
    assert got.dtype == torch.int32
    assert torch.equal(got, td.rns_polymul_lanes(a, b, plan, mod_idx).int())


def _view_at(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of x in a view that starts `offset` bytes past a 16-byte boundary."""
    step = x.element_size()
    flat = torch.zeros(x.numel() + 32 // step, dtype=x.dtype, device=x.device)
    start = (-flat.data_ptr() % 16 + offset) // step
    v = flat[start:start + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 16 == offset and v.is_contiguous()
    return v


@pytest.mark.parametrize("logn", [8, 14, 15, 18])
def test_rns32_odd_word_views_on_card(card, logn):
    """F4 on the u32 RNS kernels: int32 operands and outputs 4, 8 and 12
    bytes past a 16-byte boundary, and int64 ones 8 bytes past it, take
    one-word accesses where 16-byte ones would be misaligned and agree
    with the plain versions."""
    plan = tg.RNSMergePlan.from_params(_u32_words_ladder(logn, 3), device=card)
    midx = torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32, device=card)
    x, w = _residues(plan, 6, logn, card), _residues(plan, 6, logn + 1, card)
    x = x % torch.tensor(plan.qs, device=card)[midx.long()][:, None]
    w = w % torch.tensor(plan.qs, device=card)[midx.long()][:, None]
    fx, fw = hr32.rns_u32_fwd_plain(x, plan, midx), hr32.rns_u32_fwd_plain(w, plan, midx)
    ix = hr32.rns_u32_inv_plain(x, plan, midx)
    px = hr32.rns_u32_polymul_inv_plain(fx, fw, plan, midx)
    for dtype, offsets in ((torch.int32, (4, 8, 12)), (torch.int64, (8,))):
        for off in offsets:
            xo = _view_at(x.to(dtype), off)
            assert torch.equal(hr32.rns_u32_fwd(xo, plan, midx), fx.to(dtype)), (dtype, off)
            assert torch.equal(hr32.rns_u32_inv(xo, plan, midx), ix.to(dtype)), (dtype, off)
            got = hr32.rns_u32_polymul_inv(_view_at(fx.to(dtype), off), fw.to(dtype), plan,
                                           midx)
            assert torch.equal(got, px.to(dtype)), (dtype, off)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("logn", [14, 15])
def test_rns32_whole_ring_kernels_match_plain_on_card(card, logn, dtype, poly):
    """The whole-ring kernels (a cluster of two blocks a ring, one launch
    and one pass over device memory a transform) on a ladder of 30 primes
    of 30 bits, the u32 HE cell's, against their plain versions: batches
    of 1, 3 and 61 rings (a lone ring, batches that are no multiple of
    anything) and the cell's 480, on int32 and int64 lanes."""
    plan = tg.RNSMergePlan.from_params(_u32_words_ladder(logn, poly=poly), device=card)
    for rows in (1, 3, 61, 480):
        midx = (torch.arange(rows, dtype=torch.int32, device=card) % plan.mod_count).flip(0)
        q = torch.tensor(plan.qs, device=card)[midx.long()][:, None]
        x, w = ((_residues(plan, rows, rows + s, card) % q).to(dtype) for s in (0, 1))
        fx, fw = hr32.rns_u32_fwd(x, plan, midx), hr32.rns_u32_fwd(w, plan, midx)
        ix = hr32.rns_u32_inv(x, plan, midx)
        px = hr32.rns_u32_polymul_inv(fx, fw, plan, midx)
        torch.cuda.synchronize()
        assert fx.dtype == ix.dtype == px.dtype == dtype
        assert torch.equal(fx, hr32.rns_u32_fwd_plain(x, plan, midx)), rows
        assert torch.equal(ix, hr32.rns_u32_inv_plain(x, plan, midx)), rows
        assert torch.equal(px, hr32.rns_u32_polymul_inv_plain(fx, fw, plan, midx)), rows
        assert torch.equal(hr32.rns_u32_inv(fx, plan, midx), x), rows


def _device_ops(prof, tmp_path) -> list:
    """The names of the kernels, copies and sets in a profile's device trace."""
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.mark.parametrize("logn,passes", [(14, 1), (15, 1), (16, 2)])
def test_u32_launches_and_passes_per_transform_on_card(card, tmp_path, logn, passes):
    """Under the profiler, each u32 transform (the RNS forward, inverse
    and fused inverse on int32 lanes, and the single-modulus forward and
    inverse) is `passes` kernels of merge_u32.cu on the card, one a pass
    over device memory, and its ntt.launch span's `passes` attr reads the
    same."""
    plan = tg.RNSMergePlan.from_params(_u32_words_ladder(logn, 3), device=card)
    midx = torch.tensor([2, 0, 1], dtype=torch.int32, device=card)
    x = (_residues(plan, 3, logn, card) % torch.tensor(plan.qs, device=card)[
        midx.long()][:, None])
    one = tg.MergePlan.from_params(_u32_words_ladder(logn, 1)[0], device=card)
    calls = {"rns_u32_fwd": lambda: hr32.rns_u32_fwd(x.int(), plan, midx),
             "rns_u32_inv": lambda: hr32.rns_u32_inv(x.int(), plan, midx),
             "rns_u32_polymul_inv": lambda: hr32.rns_u32_polymul_inv(x.int(), x.int(), plan,
                                                                     midx),
             "merge_u32_fwd": lambda: hm32.merge_u32_fwd(x, one),
             "merge_u32_inv": lambda: hm32.merge_u32_inv(x, one)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        tracing.reset()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [s for s in tracing.snapshot()["spans"] if s["name"] == "ntt.launch"]
        assert [s["attrs"]["passes"] for s in spans] == [passes], name
        ops = [o for o in _device_ops(prof, tmp_path) if "merge_u32" in o]
        assert len(ops) == passes, (name, ops)


def test_rns32_int32_traced_call_on_card(card, tmp_path):
    """One traced rns_polymul_lanes call of the u32 HE cell's shape (480
    rows of 2^15 on int32 lanes): one ntt.launch span (the fused product,
    rns_u32_polymul_i32) with word 4 and passes 1, the route span's lanes
    int32, and in the device trace one kernel of merge_u32.cu, and no
    copy, set or cast."""
    plan = tg.RNSMergePlan.from_params(_u32_words_ladder(15), device=card)
    mod_idx = np.arange(480) % plan.mod_count
    a, b = (_residues(plan, 480, s, card).int() for s in (1, 2))
    want = td.rns_polymul_lanes(a, b, plan, mod_idx)
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = td.rns_polymul_lanes(a, b, plan, mod_idx)
        torch.cuda.synchronize()
    spans = tracing.snapshot()["spans"]
    assert [s["attrs"] for s in spans if s["name"] == "ntt.launch"] == [
        {"kernel": "rns_u32_polymul_i32", "word": 4, "passes": 1}]
    assert [s["attrs"]["lanes"] for s in spans if s["name"] == "ntt.route"] == ["int32"]
    ops = _device_ops(prof, tmp_path)
    assert len(ops) == 1 and "merge_u32" in ops[0], ops
    assert out.dtype == torch.int32 and torch.equal(out, want)


@pytest.mark.parametrize("schedule", ["one entry", "per ring"])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", [14, 15])
def test_rns32_fused_product_matches_plain_on_card(card, logn, poly, schedule):
    """The fused u32 product (rns_u32_polymul and its _i32 twin: both
    forwards, the product and the inverse in one launch, a row pair on a
    cluster of 2^(logn - 13) blocks) on any u32 word, int64 and int32
    lanes, ladder 3, four rows under one schedule entry or one a ring,
    equals the plain versions and the three launches bit for bit; so do
    operands and outputs 4, 8 and 12 bytes past a 16-byte boundary
    (int32) or 8 (int64), and the output in place over a."""
    import ctypes

    from gpuntt_tpu_torch.ops import kernel

    plan = tg.RNSMergePlan.from_params(_u32_ladder(logn, poly), device=card)
    midx, shift = ((torch.tensor([1], dtype=torch.int32, device=card), 2)
                   if schedule == "one entry" else
                   (torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=card), 0))
    rows = torch.arange(4, device=card) >> shift
    sched = midx[rows].long().cpu().numpy()
    prepared = hr32.prepare(plan, midx[rows])
    lib = kernel.library("merge_u32")
    fwd, inv = hm32.packed_tables(plan)
    wa, wb = (_words((4, plan.n), False, logn + s, card) for s in (60, 61))
    for dtype, offsets in ((torch.int64, (8,)), (torch.int32, (4, 8, 12))):
        a, b = wa.to(dtype), wb.to(dtype)  # int32 lanes: every 32-bit pattern
        ua, ub = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
        want = hr32.rns_u32_polymul_inv_plain(hr32.rns_u32_fwd_plain(ua, plan, midx, shift),
                                              hr32.rns_u32_fwd_plain(ub, plan, midx, shift),
                                              plan, midx, shift).to(dtype)
        three = hr32.rns_u32_polymul_inv(hr32.rns_u32_fwd(a, plan, midx, shift),
                                         hr32.rns_u32_fwd(b, plan, midx, shift), plan, midx,
                                         shift)
        assert torch.equal(three, want)
        assert torch.equal(hr32.rns_u32_polymul(a, b, prepared), want)
        assert torch.equal(td.rns_polymul_lanes(a, b, plan, sched), want)
        entry = getattr(lib, "rns_u32_polymul" + ("_i32" if dtype == torch.int32 else ""))
        for off in offsets:
            x, w, y = _view_at(a, off), _view_at(b, off), _view_at(a, off)
            for out in (y, x):  # a separate output off 16 bytes, then in place over a
                rc = entry(0, x.data_ptr(), w.data_ptr(), out.data_ptr(), 4, logn, 0,
                           midx.data_ptr(), midx.numel(), shift, fwd.data_ptr(),
                           inv.data_ptr(), plan.consts.data_ptr(), int(plan.xnp),
                           ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                torch.cuda.synchronize()
                assert rc == 0 and torch.equal(out, want), (dtype, off)


@pytest.mark.parametrize("schedule", ["one entry", "per ring"])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(11, 16))
def test_rns_u64_whole_ring_matches_plain_on_card(card, logn, poly, schedule):
    """K12's whole-ring kernel (one plain block a ring at logn 11-12, a
    cluster of 2, 4 or 8 blocks at 13, 14, 15): forward, inverse and fused
    inverse on any u64 word against their plain versions, ladder 3, under
    one schedule entry for all four rows or one a ring; then on operands
    and outputs that start at an odd word (8-byte aligned, not 16), the
    fused inverse with one operand aligned and one not."""
    plan = tg.RNSMergePlan.from_params(_rns_members(logn, poly), device=card)
    midx, shift = ((torch.tensor([1], dtype=torch.int32, device=card), 2)
                   if schedule == "one entry" else
                   (torch.tensor([2, 0, 1, 2], dtype=torch.int32, device=card), 0))
    x = _words((4, plan.n), True, logn + 40, card)
    fx = hr.rns_u64_fwd(x, plan, midx, shift)
    fb = hr.rns_u64_fwd_plain(x.flip(0).contiguous(), plan, midx, shift)
    assert torch.equal(fx, hr.rns_u64_fwd_plain(x, plan, midx, shift))
    assert torch.equal(hr.rns_u64_inv(x, plan, midx, shift),
                       hr.rns_u64_inv_plain(x, plan, midx, shift))
    px = hr.rns_u64_polymul_inv_plain(fx, fb, plan, midx, shift)
    assert torch.equal(hr.rns_u64_polymul_inv(fx, fb, plan, midx, shift), px)

    def odd(v):
        flat = torch.zeros(v.numel() + 2, dtype=torch.int64, device=card)
        start = 1 if flat.data_ptr() % 16 == 0 else 0
        o = flat[start:start + v.numel()].view(v.shape)
        o.copy_(v)
        assert o.data_ptr() % 16 == 8 and o.is_contiguous()
        return o

    assert torch.equal(hr.rns_u64_fwd(odd(x), plan, midx, shift), fx)
    assert torch.equal(hr.rns_u64_inv(odd(x), plan, midx, shift),
                       hr.rns_u64_inv_plain(x, plan, midx, shift))
    assert torch.equal(hr.rns_u64_polymul_inv(fx, odd(fb), plan, midx, shift), px)
    assert torch.equal(hr.rns_u64_polymul_inv(odd(fx), odd(fb), plan, midx, shift), px)


@pytest.mark.parametrize("logn,passes", [(13, 1), (15, 1), (16, 2)])
def test_u64_launches_and_passes_per_transform_on_card(card, tmp_path, logn, passes):
    """Under the profiler, each u64 transform (K12's forward, inverse and
    fused inverse, and K1-K3) is `passes` kernels of merge_u64.cu on the
    card, one a pass over device memory, and its ntt.launch span's
    `passes` attr reads the same."""
    plan = tg.RNSMergePlan.from_params(_rns_members(logn, tg.ReductionPolynomial.X_N_plus),
                                       device=card)
    midx = torch.tensor([2, 0, 1], dtype=torch.int32, device=card)
    x = _words((3, plan.n), True, logn, card)
    one = tg.MergePlan.from_params(_rns_members(logn, tg.ReductionPolynomial.X_N_plus, 1)[0],
                                   device=card)
    calls = {"rns_u64_fwd": lambda: hr.rns_u64_fwd(x, plan, midx),
             "rns_u64_inv": lambda: hr.rns_u64_inv(x, plan, midx),
             "rns_u64_polymul_inv": lambda: hr.rns_u64_polymul_inv(x, x, plan, midx),
             "merge_u64_fwd": lambda: hm.merge_u64_fwd(x, one),
             "merge_u64_inv": lambda: hm.merge_u64_inv(x, one),
             "merge_u64_polymul_inv": lambda: hm.merge_u64_polymul_inv(x, x, one)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        tracing.reset()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [s for s in tracing.snapshot()["spans"] if s["name"] == "ntt.launch"]
        assert [s["attrs"]["passes"] for s in spans] == [passes], name
        ops = [o for o in _device_ops(prof, tmp_path) if "merge_u64" in o]
        assert len(ops) == passes, (name, ops)


def test_rns_u64_traced_call_on_card(card, tmp_path):
    """One traced rns_polymul_lanes call of the u64 HE cell's shape (240
    rows of 2^15, ladder 15, X^N + 1): one ntt.launch span (K12's product
    in one C call) with word 8 and passes 1, and in the device trace three
    kernels of merge_u64.cu, one a transform, and no copy, set or cast."""
    plan = tg.RNSMergePlan.from_params(_rns_members(15, tg.ReductionPolynomial.X_N_plus, 15),
                                       device=card)
    mod_idx = np.arange(240) % plan.mod_count
    midx = torch.tensor(mod_idx, dtype=torch.int32, device=card)
    a, b = (_residues(plan, 240, s, card) for s in (1, 2))
    want = hr.rns_u64_polymul_inv(hr.rns_u64_fwd(a, plan, midx), hr.rns_u64_fwd(b, plan, midx),
                                  plan, midx)
    td.rns_polymul_lanes(a, b, plan, mod_idx)
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = td.rns_polymul_lanes(a, b, plan, mod_idx)
        torch.cuda.synchronize()
    spans = tracing.snapshot()["spans"]
    assert [(s["attrs"]["kernel"], s["attrs"]["word"], s["attrs"]["passes"]) for s in spans
            if s["name"] == "ntt.launch"] == [("rns_u64_polymul", 8, 1)]
    ops = _device_ops(prof, tmp_path)
    assert len(ops) == 3 and all("merge_u64" in o and "::ring<" in o for o in ops), ops
    assert out.dtype == torch.int64 and torch.equal(out, want)


# ------------------------------------------------- the 2^27 ZK transform


def _zk_n27(card):
    """A plan of the benchmark's 2^27 ZK configuration (its 59-bit prime,
    X^N - 1) on the card, and one operand of 1 GiB."""
    from portbench import harness
    from portbench.reference import primes

    cfg = harness.config("zk_u64_n27")
    q, logn = cfg["q"], cfg["logn"]
    p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_minus, np.uint64,
                         factors=tg.NTTFactors(tg.Modulus64(q), *primes.root_pair(q, logn)))
    gen = torch.Generator(device=card).manual_seed(27)
    x = torch.randint(0, q, (1, p.n), generator=gen, dtype=torch.int64, device=card)
    return tg.MergePlan.from_params(p, device=card), x


def test_zk_n27_transforms_match_plain_on_card(card):
    """The ZK cell's transforms at 2^27 through ntt_lanes / intt_lanes: the
    nested big ring (K7 at A = 512 twice, then K8: three launches a
    direction) against the plain versions' composition on the card, and
    the round trip."""
    plan, x = _zk_n27(card)
    lp = hml.large_plan(plan)
    tracing.reset()
    fx = tg.ntt_lanes(x, plan)
    ix = tg.intt_lanes(x, plan)
    torch.cuda.synchronize()
    assert _large_counts() == {hml.COLFWD.name: (2, 0), hml.COLINV.name: (2, 0),
                               hml.ROWMAT.name: (2, 0)}
    assert torch.equal(fx, hml.merge_u64_large_plain(x, lp))
    assert torch.equal(ix, hml.merge_u64_large_plain(x, lp, inverse=True))
    del ix
    assert torch.equal(tg.intt_lanes(fx, plan), x)


def test_zk_n27_spans_carry_three_passes_on_card(card, tmp_path):
    """Under the profiler, a 2^27 transform's route span reads passes 3,
    its three launch spans are K7, K7, K8 forward (K8, K7, K7 inverse),
    and its device trace is those three kernels of merge_u64_large.cu."""
    plan, x = _zk_n27(card)
    fx = tg.ntt_lanes(x, plan)  # the big-ring plan is built at the first call
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for fn, y, ks in ((tg.ntt_lanes, x, (hml.COLFWD, hml.COLFWD, hml.ROWMAT)),
                      (tg.intt_lanes, fx, (hml.ROWMAT, hml.COLINV, hml.COLINV))):
        torch.cuda.synchronize()
        tracing.reset()
        with torch.profiler.profile(activities=acts) as prof:
            fn(y, plan)
            torch.cuda.synchronize()
        spans = tracing.snapshot()["spans"]
        assert [s["attrs"]["passes"] for s in spans if s["name"] == "ntt.route"] == [3]
        assert [s["attrs"]["kernel"] for s in spans
                if s["name"] == "ntt.launch"] == [k.name for k in ks]
        ops = _device_ops(prof, tmp_path)
        assert len(ops) == 3 and all("merge_u64_large::" in o for o in ops), ops


# ------------------------------------------------------- the distributed path


@pytest.mark.parametrize("sp", [1, 2, 4, 8])
@pytest.mark.parametrize("logn", [20, 24])
def test_k7_local_matches_plain_on_card(card, logn, sp):
    """K7' on every shard of sp, at the dist 4-step's colmat shapes (u64
    2^20: 32 x 32768, 2^24: 256 x 65536): against its plain version and
    the same columns of the sp = 1 launch, both directions, one launch
    each, any u64 word."""
    from gpuntt_tpu_torch.parallel.fourstep_dist import DistFourStepPlan

    p = tg.NTTParameters4Step(logn, POLYS[0], np.uint64)
    lp = DistFourStepPlan.from_params(p, device=card).colmat
    x = from_numpy_u64(np.random.default_rng(sp).integers(
        0, 1 << 64, size=(1, p.n), dtype=np.uint64, endpoint=False), card).view(1, p.n1, p.n2)
    bl = p.n2 // sp
    for inverse in (False, True):
        whole = hml.col_phase_local(x, lp, 0, 1, inverse)
        for sh in range(sp):
            xs = x[:, :, sh * bl:(sh + 1) * bl].contiguous()
            tracing.reset()
            got = hml.col_phase_local(xs, lp, sh, sp, inverse)
            torch.cuda.synchronize()
            k = hml.COLINV_LOCAL if inverse else hml.COLFWD_LOCAL
            assert (k.launches, k.plain_calls) == (1, 0)
            assert torch.equal(got, hml.col_phase_local_plain(xs, lp, sh, sp, inverse))
            assert torch.equal(got, whole[:, :, sh * bl:(sh + 1) * bl])


def test_k7_local_refuses_on_card(card):
    from gpuntt_tpu_torch.parallel.fourstep_dist import DistFourStepPlan

    p = tg.NTTParameters4Step(16, POLYS[0], np.uint64)
    lp = DistFourStepPlan.from_params(p, device=card).colmat
    x = torch.zeros((1, p.n1, p.n2), dtype=torch.int64, device=card)
    for args in ((x.cpu(), 0, 1), (x[:, :, :64].contiguous(), 0, 8), (x, 1, 1),
                 (x[:, :, :256], 0, 2)):
        with pytest.raises(tg.NTTDispatchError):
            hml.col_phase_local(args[0], lp, args[1], args[2], False)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn,sp", [(14, 4), (20, 8), (20, 4), (21, 8)])
def test_merge_dist_tails_on_card(card, logn, sp, poly):
    """Every rank's tail plan (MergePlan.from_eval): 2^12 and 2^17 tails
    on K1/K2, 2^18 tails on the twisted big-ring plan, against their plain
    versions and against the tail cut from the full network's tables on
    the engine (2^12)."""
    from gpuntt_tpu_torch.parallel.merge_dist import _sliced_tail, merge_dist_tails

    plan = tg.MergePlan.from_params(tg.NTTParameters(logn, poly, np.uint64), device=card)
    rng = np.random.default_rng(logn + sp)
    for r in range(sp):
        tail = merge_dist_tails(plan, sp, r)
        x = from_numpy_u64(rng.integers(0, plan.q, size=(2, tail.n), dtype=np.uint64), card)
        tracing.reset()
        f, i = tg.ntt_lanes(x, tail), tg.intt_lanes(x, tail)
        torch.cuda.synchronize()
        if tail.bigring:
            lp = hml.large_plan(tail)
            assert (hml.COLFWD.launches, hml.COLINV.launches) == (1, 1)
            assert torch.equal(f, hml.merge_u64_large_plain(x, lp))
            assert torch.equal(i, hml.merge_u64_large_plain(x, lp, inverse=True))
        else:
            assert (hm.FORWARD.launches, hm.INVERSE.launches) == (1, 1)
            assert torch.equal(f, hm.merge_u64_fwd_plain(x, tail))
            assert torch.equal(i, hm.merge_u64_inv_plain(x, tail))
        if logn == 14:
            cut = _sliced_tail(plan, sp, r)
            assert torch.equal(f, tg.ntt_lanes(x, cut))


@pytest.fixture(scope="module")
def nccl_mesh():
    """A world of one rank on NCCL (a HashStore: no network) and its 1 x 1
    mesh; the group is destroyed after the module."""
    import torch.distributed as dist

    from gpuntt_tpu_torch.parallel import mesh as M

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    yield M.make_mesh(1, 1)
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype,logn", [(np.uint64, 20), (np.uint64, 24), (np.uint32, 20),
                                        (np.uint64, 16)])
def test_dist_fourstep_world_one_on_card(card, nccl_mesh, dtype, logn):
    """dist_fourstep_ntt / _intt at world size 1 on NCCL equal the
    single-chip fourstep_ntt_full and invert it; pipelined too."""
    from gpuntt_tpu_torch.parallel.fourstep_dist import (DistFourStepPlan, dist_fourstep_intt,
                                                         dist_fourstep_ntt)

    p = tg.NTTParameters4Step(logn, POLYS[0], dtype)
    dplan = DistFourStepPlan.from_params(p, device=card)
    batch = 2 if logn < 24 else 1
    x_np = np.random.default_rng(logn).integers(0, p.modulus.value, size=(batch, p.n),
                                                dtype=np.uint64)
    x = torch.from_numpy(x_np.view(np.int64)).to(card)
    want = tg.fourstep_ntt_full(x, tg.FourStepPlan.from_params(p, device=card))
    for chunks in (1, batch):
        spec = dist_fourstep_ntt(x.view(batch, p.n1, p.n2), dplan, nccl_mesh,
                                 pipeline_chunks=chunks)
        assert torch.equal(spec.reshape(batch, p.n), want)
        back = dist_fourstep_intt(spec, dplan, nccl_mesh, pipeline_chunks=chunks)
        assert torch.equal(back.reshape(batch, p.n), x)


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("dtype,logn", [(np.uint64, 14), (np.uint64, 20), (np.uint32, 20)])
def test_dist_merge_world_one_on_card(card, nccl_mesh, dtype, logn, poly):
    from gpuntt_tpu_torch.parallel.merge_dist import dist_merge_intt, dist_merge_ntt

    p = tg.NTTParameters(logn, poly, dtype)
    plan = tg.MergePlan.from_params(p, device=card)
    x = torch.from_numpy(np.random.default_rng(logn).integers(
        0, p.modulus.value, size=(2, p.n), dtype=np.uint64).view(np.int64)).to(card)
    f = dist_merge_ntt(x, plan, nccl_mesh)
    assert torch.equal(f, tg.ntt_lanes(x, plan))
    assert torch.equal(dist_merge_intt(f, plan, nccl_mesh), x)
    unscaled = dist_merge_intt(f, plan, nccl_mesh, scale=False)
    assert torch.equal(plan.ops().mulc(unscaled, plan.n_inv, signed(plan.n_inv_shoup)), x)


def test_dist_models_world_one_on_card(card, nccl_mesh):
    """Both Dist models at world size 1 against the single-chip polymuls."""
    from gpuntt_tpu_torch.models.polymul import (DistPolynomialMultiplier,
                                                 DistRNSPolynomialMultiplier)

    qs = tg.find_ntt_primes(59, 16, 3)
    rng = np.random.default_rng(7)
    fours, merges = [], []
    for q in qs:
        f = tg.NTTFactors(tg.Modulus64(q), *tg.ntt_root_pair(q, 16))
        fours.append(tg.NTTParameters4Step(16, POLYS[0], np.uint64, factors=f))
        merges.append(tg.NTTParameters(16, POLYS[0], np.uint64, factors=f))
    a, b = (from_numpy_u64(np.stack([rng.integers(0, q, size=1 << 16, dtype=np.uint64)
                                     for q in qs]), card) for _ in range(2))
    p0 = fours[0]
    out = DistRNSPolynomialMultiplier(fours, nccl_mesh).step_lanes(
        a.view(3, p0.n1, p0.n2), b.view(3, p0.n1, p0.n2), [0, 1, 2])
    want = td.rns_polymul_lanes(a, b, tg.RNSMergePlan.from_params(merges, device=card),
                                [0, 1, 2])
    assert torch.equal(out.reshape(3, -1), want)
    model = DistPolynomialMultiplier(p0, nccl_mesh, pipeline_chunks=3)
    single = tg.MergePlan.from_params(merges[0], device=card)
    a0 = from_numpy_u64(rng.integers(0, qs[0], size=(3, 1 << 16), dtype=np.uint64), card)
    out = model(a0.view(3, p0.n1, p0.n2), a0.view(3, p0.n1, p0.n2))
    assert torch.equal(out.reshape(3, -1), tg.polymul_lanes(a0, a0, single))


# ------------------------------------------ K15 and K17 (csrc/kmerge.cu)


def _kmerge_params(logn, poly, dtype, bits):
    """The pool prime (bits None) or a found prime of `bits` bits."""
    if bits is None:
        return tg.NTTParameters(logn, poly, dtype)
    q = tg.find_ntt_primes(bits, logn, 1)[0]
    mod = tg.Modulus64 if dtype == np.uint64 else tg.Modulus32
    return tg.NTTParameters(logn, poly, dtype,
                            factors=tg.NTTFactors(mod(q), *tg.ntt_root_pair(q, logn)))


@pytest.mark.parametrize("bits", [None, 63, 46])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(7, 25))
def test_kmerge_u64_matches_plain_on_card(card, logn, poly, bits):
    """K15's counterpart at every logn it takes (one block per ring up to
    14, column and row launches above), on the pool prime, a q past 2^62
    and a 46-bit q, on any u64 word; ntt_lanes with use_pallas="vpu"
    launches it."""
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64

    p = _kmerge_params(logn, poly, np.uint64, bits)
    plan = tg.MergePlan.from_params(p, device=card)
    kp = hk.kernel_plan(plan)
    x = from_numpy_u64(np.random.default_rng(logn).integers(
        0, 1 << 64, size=(1 if logn > 20 else 2, p.n), dtype=np.uint64, endpoint=False), card)
    tracing.reset()
    fx, ix = hk64.kmerge_u64(x, kp), hk64.kmerge_u64(x, kp, inverse=True)
    torch.cuda.synchronize()
    assert [(k.launches, k.plain_calls) for k in hk64.KERNELS] == [(1, 0), (1, 0)]
    assert torch.equal(fx, hk.kmerge_plain(x, kp))
    assert torch.equal(ix, hk.kmerge_plain(x, kp, inverse=True))
    xr = bo.reduce_forced64(x, p.modulus.value)
    assert torch.equal(tg.ntt_lanes(xr, plan, use_pallas="vpu"), fx)
    assert torch.equal(tg.intt_lanes(fx, plan, use_pallas="vpu"), xr)
    assert hk64.FORWARD.launches == 2 and hk64.INVERSE.launches == 2


# (q, psi of order 2^13): the largest NTT prime below 2^62 of order 2^14
# (WIDE62) and a q just past 2^62 (OVER62)
_WIDE62 = (4611684918915809281, 4166544109213919754)
_OVER62 = (4611686018427494401, 795177494079348431)


def _kmerge_policy_params(case, logn, poly):
    """WIDE62 or OVER62 (logn <= 12), or the largest NTT prime below 2^62
    ("edge62") or 2^63 ("q63") of the ring."""
    if case in ("wide62", "over62"):
        q, psi = _WIDE62 if case == "wide62" else _OVER62
        psi = pow(psi, 1 << (12 - logn), q)
        return tg.NTTParameters(logn, poly, np.uint64, factors=tg.NTTFactors(
            tg.Modulus64(q), psi * psi % q, psi))
    return _factored(logn, poly, np.uint64,
                     largest_ntt_prime(62 if case == "edge62" else 63, logn))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("case,logn", [("wide62", 12), ("over62", 12), ("q63", 12),
                                       ("edge62", 16), ("q63", 16), ("edge62", 17),
                                       ("q63", 17), ("q63", 24)])
def test_kmerge_u64_value_policy_on_card(card, case, logn, poly):
    """K15's counterpart on both sides of 2^62, where kmerge.cu switches
    from its lazy instance to its canonical one: the lazy instance at its
    edge (WIDE62, the largest NTT prime below 2^62), the canonical one
    past it (OVER62, the largest 63-bit NTT prime), in the one-block form
    (12), one and two column runs (16, 17) and at logn 24, on any u64
    word, against the plain version."""
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64

    p = _kmerge_policy_params(case, logn, poly)
    assert (p.modulus.value < 1 << 62) == (case in ("wide62", "edge62"))
    kp = hk.KernelMergePlan.from_params(p, device=card)
    x = from_numpy_u64(np.random.default_rng(logn + 1).integers(
        0, 1 << 64, size=(1 if logn > 20 else 3, p.n), dtype=np.uint64, endpoint=False), card)
    fx, ix = hk64.kmerge_u64(x, kp), hk64.kmerge_u64(x, kp, inverse=True)
    assert torch.equal(fx, hk.kmerge_plain(x, kp))
    assert torch.equal(ix, hk.kmerge_plain(x, kp, inverse=True))
    assert torch.equal(hk64.kmerge_u64(fx, kp, inverse=True),
                       bo.reduce_forced64(x, p.modulus.value))


@pytest.mark.parametrize("widest", [False, True])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(7, 26))
def test_kmerge_u32_matches_plain_on_card(card, logn, poly, widest):
    """K17's counterpart at every logn it takes (one block per ring up to
    15), on the pool prime and on the widest NTT prime below 2^30 for the
    ring (30 bits up to logn 23, then 28 and 29), on any u32 word."""
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk

    bits = (30 if logn <= 23 else 28 if logn == 24 else 29) if widest else None
    p = _kmerge_params(logn, poly, np.uint32, bits)
    kp = hk.KernelMergePlan.from_params(p, device=card)
    x = torch.from_numpy(np.random.default_rng(logn).integers(
        0, 1 << 32, size=(1 if logn > 20 else 2, p.n), dtype=np.int64)).to(card)
    tracing.reset()
    fx, ix = hk.kmerge_u32(x, kp), hk.kmerge_u32(x, kp, inverse=True)
    torch.cuda.synchronize()
    assert [(k.launches, k.plain_calls) for k in hk.KERNELS] == [(1, 0), (1, 0)]
    assert torch.equal(fx, hk.kmerge_plain(x, kp))
    assert torch.equal(ix, hk.kmerge_plain(x, kp, inverse=True))
    assert torch.equal(hk.kmerge_u32(fx, kp, inverse=True), x % p.modulus.value)


def test_kmerge_refuses_on_card(card):
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64

    kp = hk.KernelMergePlan.from_params(tg.NTTParameters(12, POLYS[1], np.uint64),
                                        device=card)
    x = torch.zeros((2, kp.n), dtype=torch.int64, device=card)
    for bad in (x.to(torch.int32), x.cpu(), x.reshape(-1, 2).t(), x[:, :-1]):
        with pytest.raises(tg.NTTDispatchError):
            hk64.kmerge_u64(bad, kp)
    with pytest.raises(tg.NTTDispatchError):
        hk.kmerge_u32(x, kp)


# ------------------------------------------- the probe, the entry, the examples


@pytest.mark.parametrize("is64", [True, False])
def test_probe_kernel_matches_plain(card, is64):
    """csrc/probe.cu's chain against its plain version on the card, at the
    pool prime and the largest NTT prime below 2^62 / 2^30, edge words
    and a ragged count included, depths 0, 1 and 7; then a short
    measure_modmul_peak."""
    from gpuntt_tpu_torch.utils import profiling as pr

    rng = np.random.default_rng(0)
    pool = 576460756061519873 if is64 else 469762049
    for q in (pool, largest_ntt_prime(62 if is64 else 30, 17)):
        x = from_numpy_u64(np.concatenate([np.array([0, 1, q - 1], dtype=np.uint64),
                                           rng.integers(0, q, 100003, dtype=np.uint64)]), card)
        for w in (1, q - 1, int(rng.integers(2, q - 1))):
            for depth in (0, 1, 7):
                tracing.reset()
                got = pr.shoup_chain(x, w, q, depth, is64)
                torch.cuda.synchronize()
                stats = pr.CHAIN64 if is64 else pr.CHAIN32
                assert (stats.launches, stats.plain_calls) == (1, 0)
                assert torch.equal(got, pr.shoup_chain_plain(x, w, q, depth, is64))
    rate = pr.measure_modmul_peak(pool, is64, depth=16, elems=1 << 20, device=card)
    assert np.isfinite(rate) and rate > 0


def test_entry_graph_capture(card):
    """The entry's step (u64 2^12 x 4) captured in a CUDA graph: the
    replay equals the eager call and NTTCPU."""
    from gpuntt_tpu_torch import entry as E

    fn, args = E.entry(card)
    eager, replay, graph = E.graph_check(fn, args)
    assert torch.equal(replay, eager)
    assert np.array_equal(to_numpy_u64(replay), E.golden())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replay, eager)


def test_headline_polymul_graph_capture(card):
    """polymul_lanes at the headline u64 2^16 x 128 (K1 twice, K3) captured
    in a CUDA graph: replay == eager == NTTCPU on every row."""
    from gpuntt_tpu_torch import entry as E

    p = tg.NTTParameters(16, POLYS[1], np.uint64)
    plan = tg.MergePlan.from_params(p, device=card)
    rng = np.random.default_rng(1)
    a_np, b_np = (rng.integers(0, p.modulus.value, (128, p.n), dtype=np.uint64)
                  for _ in range(2))
    tracing.reset()
    eager, replay, _ = E.graph_check(lambda u, v: tg.polymul_lanes(u, v, plan),
                                     (from_numpy_u64(a_np, card), from_numpy_u64(b_np, card)))
    assert [k.launches for k in hm.KERNELS] == [6, 0, 3]
    assert torch.equal(replay, eager)
    gen = tg.NTTCPU(p)
    assert np.array_equal(to_numpy_u64(replay), gen.intt(gen.mult(gen.ntt(a_np),
                                                                  gen.ntt(b_np))))


@pytest.mark.parametrize("name,args,want", [
    ("example_merge_ntt", ("16", "128"), {"merge_u64_forward": 3}),
    ("example_rns_ntt", ("16", "64"), {"rns_u64_forward": 2, "rns_u64_inverse": 2}),
])
def test_example_on_card(card, capsys, name, args, want):
    """The example at its PERF.md §4 cell on the card: `All Correct.`,
    rc 0, and its route's launches."""
    import importlib

    mod = importlib.import_module(f"gpuntt_tpu_torch.examples.{name}")
    tracing.reset()
    assert mod.main([*args, f"--device={card}"]) == 0
    assert "All Correct." in capsys.readouterr().out.splitlines()
    torch.cuda.synchronize()
    ran = {k.name: k.launches for k in (*hm.KERNELS, *hr.KERNELS) if k.launches}
    assert ran == want
    assert not any(k.plain_calls for k in (*hm.KERNELS, *hr.KERNELS))


def test_launch_spans_match_launch_counts_on_card(card):
    """Under torch.profiler, each rns_polymul_lanes call (30 rows of 2^15,
    ladder 15, as the single HE cell) records one ntt.launch span, the
    one C call of K12's product (rns_u64_polymul), inside its ntt.entry
    span, after a route that finds the plan and the schedule on the card;
    the kernels count their launches as before, two K12 forwards and the
    fused inverse a call."""
    from collections import Counter

    plan = tg.RNSMergePlan.from_params(_rns_members(15, tg.ReductionPolynomial.X_N_plus, 15),
                                       device=card)
    rng = np.random.default_rng(16)
    a, b = (from_numpy_u64(rng.integers(0, min(plan.qs), (30, plan.n), dtype=np.uint64), card)
            for _ in range(2))
    mod_idx = np.arange(30) % 15
    want = td.rns_polymul_lanes(a, b, plan, mod_idx)
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        outs = [td.rns_polymul_lanes(a, b, plan, mod_idx) for _ in range(4)]
        torch.cuda.synchronize()
    snap = tracing.snapshot()
    spans = snap["spans"]
    launches = sum(k["launches"] for k in snap["kernels"].values())
    entries = [s for s in spans if s["name"] == "ntt.entry"]
    launch_spans = [s for s in spans if s["name"] == "ntt.launch"]
    assert launches == 12 and len(launch_spans) == len(entries) == 4
    assert (hr.FORWARD.launches, hr.POLYMUL_INVERSE.launches) == (8, 4)
    assert Counter(s["call"] for s in launch_spans) == {e["call"]: 1 for e in entries}
    assert all(spans[s["parent"]]["name"] == "ntt.entry" for s in launch_spans)
    assert Counter(s["attrs"]["kernel"] for s in launch_spans) == {"rns_u64_polymul": 4}
    assert [s["attrs"] for s in spans if s["name"] == "ntt.route"] == [
        {"plan": "hit", "schedule": "hit", "path": "hopper-rns", "lanes": "int64"}] * 4
    assert tracing.split_ms(spans)["launch"] > 0
    assert all(torch.equal(out, want) for out in outs)
