"""The RNS kernels K12, K13 and K14 on the CPU (exact equality).

- Their plain versions against the Pallas kernels they replace, in
  interpret mode, at the JAX tests' own sizes: K12 at logn 12 with a
  ladder of 3 (tests/test_mxu_rns.py:19), K13 at logn 14 with 2
  (test_mxu_rns.py:76, rows of 128 on the row kernel), K14 at logn 14
  with 2 (tests/test_fourstep_rns.py:68, rows of 512), both directions,
  on ordered schedules.
- The CUDA sources' RNS entries compiled by g++ through
  test_torch_merge.py's host emulation, against the plain versions:
  K12 at logn 11-17 (one schedule entry per row, and per ring of two
  rows), K13's column kernels at logn 18 and its row kernel at a split
  of 128 x 128, K14 at logn 14 and 17, the whole compositions through
  the emulated kernels, and the shapes the entries refuse.
- The wrappers' contract: plain versions for CPU tensors only, errors
  for other devices, schedules and shapes the kernels do not take.
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import pallas_mxu_rns as pr
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops.merge_ntt import to_lanes
from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus


def ladder(pkg, logn, mc, poly, four=False):
    out = []
    for q in pkg.find_ntt_primes(59, logn, mc):
        omega, psi = pkg.ntt_root_pair(q, logn)
        params = pkg.NTTParameters4Step if four else pkg.NTTParameters
        out.append(params(logn, pkg.ReductionPolynomial(poly.value), np.uint64,
                          factors=pkg.NTTFactors(pkg.Modulus64(q), omega, psi)))
    return out


def residues(qs, mod_idx, n, seed):
    """Row b canonical under modulus mod_idx[b]."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, qs[m], n, dtype=np.uint64) for m in mod_idx])


def words(shape, seed):
    """Any u64 words: the kernels reduce their input first."""
    return to_lanes(np.random.default_rng(seed).integers(0, 1 << 64, size=shape,
                                                         dtype=np.uint64), True)


def sched(mod_idx):
    return torch.tensor(mod_idx, dtype=torch.int32)


# ---------------------------------------- plain versions against Pallas


def test_k12_plain_matches_pallas():
    jm = ladder(jg, 12, 3, PLUS)
    plan = tg.RNSMergePlan.from_params(ladder(tg, 12, 3, PLUS), device="cpu")
    rplan = pr.MXURNSPlan.from_members(jm)
    mod_idx = [2, 0, 1, 2, 0]
    x = residues(plan.qs, mod_idx, plan.n, 1)
    for inverse, plain in ((False, hr.rns_u64_fwd_plain), (True, hr.rns_u64_inv_plain)):
        want = jfrom(pr.pallas_mxu_rns_u64(jto(x, True), rplan, np.array(mod_idx),
                                           inverse=inverse, interpret=True), True)
        got = plain(to_lanes(x, True), plan, sched(mod_idx))
        np.testing.assert_array_equal(tg.ops.merge_ntt.from_lanes(got, True), want)


def test_k13_plain_matches_pallas():
    """At logn 14 both packages split 128 x 128 and run the rows on the
    row kernel (the route's K13 starts at 18; this is the JAX test's
    cell)."""
    jm = ladder(jg, 14, 2, PLUS)
    members = ladder(tg, 14, 2, PLUS)
    lplan = pr.MXULargeRNSPlan.from_members(jm)
    sp = hr.RNSColumnPlan.from_members([hml.LargePlan.from_params(p, a_col=128, device="cpu")
                                        for p in members])
    assert (sp.first.A, sp.first.B, lplan.A, lplan.B) == (128, 128, 128, 128)
    mod_idx = [0, 1, 0]
    x = residues(sp.col.qs, mod_idx, 1 << 14, 2)
    for inverse in (False, True):
        want = jfrom(pr.pallas_mxu_large_rns_u64(jto(x, True), lplan, np.array(mod_idx),
                                                 inverse=inverse, interpret=True), True)
        got = hr.rns_u64_large_plain(to_lanes(x, True), sp, sched(mod_idx), inverse)
        np.testing.assert_array_equal(tg.ops.merge_ntt.from_lanes(got, True), want)


def test_k14_plain_matches_pallas():
    jm = ladder(jg, 14, 2, MINUS, four=True)
    plan = tg.RNSFourStepPlan.from_params(ladder(tg, 14, 2, MINUS, four=True), device="cpu")
    mplan = pr.FourStepRNSMXUPlan.from_members(jm)
    sp = hr.fourstep_plan(plan)
    mod_idx = [1, 0, 1]
    x = residues(plan.qs, mod_idx, plan.n, 3)
    for inverse in (False, True):
        want = jfrom(pr.fourstep_mxu_rns_lanes(jto(x, True), mplan, np.array(mod_idx),
                                               inverse=inverse, interpret=True), True)
        got = hr.rns_fourstep_plain(to_lanes(x, True), sp, sched(mod_idx), inverse)
        np.testing.assert_array_equal(tg.ops.merge_ntt.from_lanes(got, True), want)


# ------------------------------------------------ the CUDA sources, emulated


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return {name: _emulate(tmp_path_factory, name)
            for name in ("merge_u64", "merge_u64_large", "fourstep")}


def _k12(lib, entry, plan, midx, shift, *xs):
    inverse = entry != "rns_u64_forward"
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(xs[0])
    rc = getattr(lib, entry)(0, *(x.data_ptr() for x in xs), y.data_ptr(), xs[0].shape[0],
                             plan.logn, hm.split(plan.logn), midx.data_ptr(), midx.numel(),
                             shift, table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(),
                             int(plan.xnp), None)
    assert rc == 0, entry
    return y


def _col(lib, entry, x, sp, midx, inverse):
    col = sp.col
    tabs = ((col.inv_tables, col.inv_shoup, sp.wt_inv, sp.wt_inv_shoup, sp.ws_inv,
             sp.ws_inv_shoup) if inverse else
            (col.fwd_tables, col.fwd_shoup, sp.wt_fwd, sp.wt_fwd_shoup, sp.ws_fwd,
             sp.ws_fwd_shoup))
    kp = sp.first
    y = torch.empty_like(x)
    if entry.startswith("rns_fourstep"):
        rc = getattr(lib, entry)(0, x.data_ptr(), y.data_ptr(), x.shape[0],
                                 kp.n1.bit_length() - 1, kp.n2.bit_length() - 1,
                                 kp.tile.bit_length() - 1, kp.w_tile.bit_length() - 1,
                                 midx.data_ptr(), *(t.data_ptr() for t in tabs),
                                 col.consts.data_ptr(), None)
    else:
        rc = getattr(lib, entry)(0, x.data_ptr(), y.data_ptr(), x.shape[0], col.logn,
                                 kp.B.bit_length() - 1, midx.data_ptr(),
                                 *(t.data_ptr() for t in tabs), kp.tile.bit_length() - 1,
                                 col.consts.data_ptr(), int(col.xnp), None)
    assert rc == 0, entry
    return y


def _rowmat(lib, x, plan, midx, shift, inverse):
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(x)
    rc = lib.rns_u64_large_rowmat(0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn,
                                  midx.data_ptr(), midx.numel(), shift, table.data_ptr(),
                                  shoup.data_ptr(), plan.consts.data_ptr(), int(inverse),
                                  int(plan.xnp), None)
    assert rc == 0
    return y


def _emulated_steps(emu):
    lib, large, four = emu["merge_u64"], emu["merge_u64_large"], emu["fourstep"]
    return hr._Steps(
        lambda x, p, m, s: _k12(lib, "rns_u64_forward", p, m, s, x),
        lambda x, p, m, s: _k12(lib, "rns_u64_inverse", p, m, s, x),
        lambda a, b, p, m, s: _k12(lib, "rns_u64_polymul_inverse", p, m, s, a, b),
        lambda x, sp, m: _col(large, "rns_u64_large_colfwd", x, sp, m, False),
        lambda x, sp, m: _col(large, "rns_u64_large_colinv", x, sp, m, True),
        lambda x, p, m, s, inv: _rowmat(large, x, p, m, s, inv),
        lambda x, sp, m, inv: _col(four, f"rns_fourstep_u64_col_{'inv' if inv else 'fwd'}", x,
                                   sp, m, inv))


@pytest.mark.parametrize("logn", [11, 12, 13, 14, 15, 16, 17])
def test_k12_source_emulated_matches_plain(emu, logn):
    poly = PLUS if logn % 2 else MINUS
    plan = tg.RNSMergePlan.from_params(ladder(tg, logn, 3, poly), device="cpu")
    lib = emu["merge_u64"]
    for midx, shift in ((sched([2, 0, 1]), 0), (sched([1, 2, 0]), 1)):
        rows = 3 << shift
        x = words((rows, plan.n), logn)
        fa = hr.rns_u64_fwd_plain(x, plan, midx, shift)
        fb = hr.rns_u64_fwd_plain(words((rows, plan.n), logn + 1), plan, midx, shift)
        assert torch.equal(_k12(lib, "rns_u64_forward", plan, midx, shift, x), fa)
        assert torch.equal(_k12(lib, "rns_u64_inverse", plan, midx, shift, x),
                           hr.rns_u64_inv_plain(x, plan, midx, shift))
        assert torch.equal(_k12(lib, "rns_u64_polymul_inverse", plan, midx, shift, fa, fb),
                           hr.rns_u64_polymul_inv_plain(fa, fb, plan, midx, shift))


def test_k13_source_emulated_matches_plain(emu):
    """The column kernels at logn 18 (128 x 2^11), the composition with
    its rows on the emulated K12, and the row kernel at 128 x 128 (logn
    14, shift 7)."""
    plan = tg.RNSMergePlan.from_params(ladder(tg, 18, 2, PLUS), device="cpu")
    sp = hr.large_plan(plan)
    midx = sched([1, 0])
    x = words((2, plan.n), 18)
    steps = _emulated_steps(emu)
    for inverse, stats in ((False, "rns_u64_large_colfwd"), (True, "rns_u64_large_colinv")):
        got = _col(emu["merge_u64_large"], stats, x, sp, midx, inverse)
        want = (hr.colinv_plain if inverse else hr.colfwd_plain)(x, sp, midx)
        assert torch.equal(got, want), stats
        assert torch.equal(hr._large(x, sp, midx, inverse, steps),
                           hr.rns_u64_large_plain(x, sp, midx, inverse))
    fa, fb = hr.rns_u64_large_plain(x, sp, midx), hr.rns_u64_large_plain(x.flip(0), sp, midx)
    assert torch.equal(hr._large_polymul_inv(fa, fb, sp, midx, steps),
                       hr.rns_u64_large_polymul_inv_plain(fa, fb, sp, midx))
    small = hr.RNSColumnPlan.from_members([
        hml.LargePlan.from_params(p, a_col=128, device="cpu") for p in ladder(tg, 14, 2, MINUS)])
    r = words((3 << 7, 128), 14)
    midx = sched([1, 0, 1])
    for inverse in (False, True):
        assert torch.equal(_rowmat(emu["merge_u64_large"], r, small.rows, midx, 7, inverse),
                           hr.rowmat_plain(r, small.rows, midx, 7, inverse))


@pytest.mark.parametrize("logn", [14, 17])
def test_k14_source_emulated_matches_plain(emu, logn):
    plan = tg.RNSFourStepPlan.from_params(ladder(tg, logn, 2, MINUS, four=True), device="cpu")
    sp = hr.fourstep_plan(plan)
    midx = sched([1, 0, 1])
    x = words((3, plan.n), logn)
    steps = _emulated_steps(emu)
    for inverse in (False, True):
        entry = f"rns_fourstep_u64_col_{'inv' if inverse else 'fwd'}"
        assert torch.equal(_col(emu["fourstep"], entry, x, sp, midx, inverse),
                           hr.col4_plain(x, sp, midx, inverse))
        assert torch.equal(hr._fourstep(x, sp, midx, inverse, steps),
                           hr.rns_fourstep_plain(x, sp, midx, inverse))


def test_sources_emulated_refuse_bad_schedules(emu):
    plan = tg.RNSMergePlan.from_params(ladder(tg, 12, 2, PLUS), device="cpu")
    x = torch.zeros((4, plan.n), dtype=torch.int64)
    midx = sched([1, 0, 1])
    for entries, shift in ((3, 0), (3, 1), (0, 2)):  # 3 or 6 rings named for 4 rows, or none
        rc = emu["merge_u64"].rns_u64_forward(
            0, x.data_ptr(), x.data_ptr(), 4, 12, hm.split(12), midx.data_ptr(), entries, shift,
            plan.fwd_tables.data_ptr(), plan.fwd_shoup.data_ptr(), plan.consts.data_ptr(), 1,
            None)
        assert rc == 1  # cudaErrorInvalidValue
    rows = tg.RNSMergePlan.from_params(ladder(tg, 9, 2, MINUS), device="cpu")
    r = torch.zeros((16, 512), dtype=torch.int64)
    # blocks of 8 rows of 512 would span rings of 2^2 rows
    rc = emu["merge_u64_large"].rns_u64_large_rowmat(
        0, r.data_ptr(), r.data_ptr(), 16, 9, midx.data_ptr(), 4, 2, rows.fwd_tables.data_ptr(),
        rows.fwd_shoup.data_ptr(), rows.consts.data_ptr(), 0, 0, None)
    assert rc == 1


# ------------------------------------------------------ wrapper contract


def test_wrappers_take_plain_versions_on_cpu_only():
    plan = tg.RNSMergePlan.from_params(ladder(tg, 12, 2, PLUS), device="cpu")
    x = words((2, plan.n), 1)
    midx = sched([1, 0])
    tracing.reset()
    hr.rns_u64_fwd(x, plan, midx)
    hr.rns_u64_polymul_inv(x, x, plan, midx)
    assert [(k.launches, k.plain_calls) for k in hr.KERNELS[:3]] == [(0, 1), (0, 0), (0, 1)]
    assert not any(n in _build._libs for n in ("merge_u64", "merge_u64_large", "fourstep"))
    meta = plan.to("meta")
    with pytest.raises(tg.NTTDeviceError):
        hr.rns_u64_fwd(torch.empty((2, plan.n), dtype=torch.int64, device="meta"), meta,
                       midx.to("meta"))
    for bad_x, bad_m in ((x, midx.long()), (x, sched([1, 0, 1])), (x, sched([[1, 0]])),
                         (x[:, :-1], midx), (x.to(torch.int32), midx), (x.t(), midx)):
        with pytest.raises(tg.NTTDispatchError):
            hr.rns_u64_fwd(bad_x, plan, bad_m)
    with pytest.raises(tg.NTTDispatchError):  # K12 takes logn 11-17
        big = tg.RNSMergePlan.from_params(ladder(tg, 18, 2, PLUS), device="cpu")
        hr.rns_u64_fwd(torch.zeros((2, big.n), dtype=torch.int64), big, midx)


def test_rowmat_wrapper_refuses_blocks_across_rings():
    """The row kernel reads one modulus per block of 2^12 / B rows, so the
    rows of a block must lie in one ring: at B = 512 a ring needs >= 8
    rows (the 4-step's smallest covered ring, logn 14, has 32)."""
    rows = tg.RNSMergePlan.from_params(ladder(tg, 9, 2, MINUS), device="cpu")
    r = words((16, 512), 2)
    with pytest.raises(tg.NTTDispatchError):
        hr.rns_u64_large_rowmat(r, rows, sched([1, 0, 1, 0]), 2, False)
    tracing.reset()
    hr.rns_u64_large_rowmat(r, rows, sched([1, 0]), 3, False)
    assert hr.LARGE_ROWMAT.plain_calls == 1
    with pytest.raises(tg.NTTDispatchError):  # rows above 512 words are K12's
        wide = tg.RNSMergePlan.from_params(ladder(tg, 10, 2, MINUS), device="cpu")
        hr.rns_u64_large_rowmat(words((8, 1024), 3), wide, sched([1, 0]), 2, False)
