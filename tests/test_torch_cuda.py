"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

Each kernel against its plain PyTorch version on the same card, at
every logn the kernels take (u64 11-17, the u64 big rings 18-28, u32
8-25, the 4-step's 12-24 in both word sizes, the RNS kernels K12 at
11-17, K13 at 18-23, K14 at 14-23 and the stacked u32 kernels at 8-25
on cyclic and ordered schedules)
and both reduction polynomials, on any input word; wide and narrow moduli against the
golden NTTCPU, the big rings against the native oracle at 2^24 and the
4-step against NTT4StepCPU there; the RNS schedules and model
against the same entries on the CPU; the launch counters of the u32,
big-ring and 4-step routes; the wrappers' refusals; CUDA-event timing;
the distributed path: K7' on every shard of sp 1-8 at u64 2^20 and
2^24, the merge's per-rank tail plans, and the dist entries and models
at world size 1 on NCCL against the single-chip entries.
Exact equality throughout.

This file imports neither jax nor gpuntt_tpu, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops import barrett as bo
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops.limb import from_numpy_u64, signed, to_numpy_u64
from gpuntt_tpu_torch.utils.timing import time_cuda

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
    hm.reset_counts()
    hml.reset_counts()
    cf, ci = hml.merge_u64_large_colfwd(x, lp), hml.merge_u64_large_colinv(x, lp)
    torch.cuda.synchronize()
    assert _large_counts() == {hml.COLFWD.name: (1, 0), hml.COLINV.name: (1, 0)}
    assert torch.equal(cf, hml.colfwd_plain(x, lp))
    assert torch.equal(ci, hml.colinv_plain(x, lp))
    del cf, ci
    hml.reset_counts()
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
    hm.reset_counts()
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
    hm.reset_counts()
    hml.reset_counts()
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


def _fourstep_reset():
    for mod in (hf, hm, hm32):
        mod.reset_counts()


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
    _fourstep_reset()
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
    _fourstep_reset()
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
    _fourstep_reset()
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
        hr.reset_counts()
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
    hr.reset_counts()
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
    hr.reset_counts()
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
            hr.reset_counts()
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
        hr.reset_counts()
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
    through dispatch, which launch them and no plain version."""
    plan = tg.RNSMergePlan.from_params(_u32_ladder(logn, poly), device=card)
    order = [m % plan.mod_count for m in SCHEDULES[schedule]]
    midx = torch.tensor(order, dtype=torch.int32, device=card)
    k = hr32.tpu_kernel(logn)
    fwd, inv, pinv = (hr32.FORWARD[k].name, hr32.INVERSE[k].name,
                      hr32.POLYMUL_INVERSE[k].name)
    for shift in (0, 1):
        x = _words((4 << shift, plan.n), False, logn + shift, card)
        hr32.reset_counts()
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
    hr32.reset_counts()
    fx = td.ntt_rns_lanes(x, plan, order)
    assert torch.equal(td.intt_rns_lanes(fx, plan, order), x)
    px = td.rns_polymul_lanes(x, x.flip(0), plan, order)
    torch.cuda.synchronize()
    assert _rns32_counts() == {fwd: (3, 0), inv: (1, 0), pinv: (1, 0)}
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
        hr32.reset_counts()
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
            hml.reset_counts()
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
        hm.reset_counts()
        hml.reset_counts()
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
