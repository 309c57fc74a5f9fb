"""The port's RNS 4-step path against gpuntt_tpu's (CPU, exact equality).

- rns_fourstep_ntt_lanes, rns_fourstep_intt_lanes (with and without its
  scaling) and the two _full entries against the JAX package's on its
  XLA engine, u64 at logn 14 (K14, rows on K13's row kernel) and 17
  (rows on K12) and u32 at 14 (the engine), on a schedule with ordered,
  wrapped and clamped entries.  The port takes device="cpu", so the
  kernels' plain versions run where the route sends the kernels.
- The _full entries against the golden NTT4StepCPU of each row's member,
  both reduction polynomials, logn 14 and 18.
- RNSFourStepPlan.from_arrays against from_params, the route table, and
  the kernel route at logn 18, which builds no (n1, n2) W table.

Inputs are canonical residues from numpy seeds; nothing above logn 18 is
transformed here.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import fourstep_rns as jfr
from gpuntt_tpu.ops.limb import u64_to_numpy
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import fourstep_rns as tfr
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus


def ladder(pkg, logn, mc, poly, dtype, bits=None):
    is64 = dtype == np.uint64
    bits = bits or (59 if is64 else 28)
    mod = pkg.Modulus64 if is64 else pkg.Modulus32
    out = []
    for q in pkg.find_ntt_primes(bits, logn, mc):
        omega, psi = pkg.ntt_root_pair(q, logn)
        out.append(pkg.NTTParameters4Step(logn, pkg.ReductionPolynomial(poly.value), dtype,
                                          factors=pkg.NTTFactors(mod(q), omega, psi)))
    return out


@functools.cache
def plans(dtype, logn, poly, mc):
    return (jg.RNSFourStepPlan.from_params(ladder(jg, logn, mc, poly, dtype)),
            tg.RNSFourStepPlan.from_params(ladder(tg, logn, mc, poly, dtype), device="cpu"))


def data(qs, shape, seed, dtype):
    """Residues below the smallest q: canonical under every member."""
    return np.random.default_rng(seed).integers(0, min(qs), size=shape,
                                                dtype=np.uint64).astype(dtype)


ENTRIES = ("ntt_lanes", "intt_lanes", "intt_lanes(scale=False)", "ntt_full", "intt_full")


def _port(x, plan, mod_idx):
    return (tg.rns_fourstep_ntt_lanes(x, plan, mod_idx),
            tg.rns_fourstep_intt_lanes(x, plan, mod_idx),
            tg.rns_fourstep_intt_lanes(x, plan, mod_idx, scale=False),
            tg.rns_fourstep_ntt_full(x, plan, mod_idx),
            tg.rns_fourstep_intt_full(x, plan, mod_idx))


@pytest.mark.parametrize("dtype,logn,mc,route", [
    (np.uint64, 14, 2, "K13-row"),  # 32 x 512: K14, rows on K13's row kernel
    (np.uint64, 17, 2, "K12"),      # 32 x 4096: K14, rows on K12
    (np.uint32, 14, 3, None),       # the engine
])
def test_entries_match_jax(dtype, logn, mc, route):
    jplan, plan = plans(dtype, logn, MINUS, mc)
    is64 = dtype == np.uint64
    mod_idx = np.array([mc - 1, 0, -1, 5])  # ordered, wrapped (-1) and clamped (5)
    x = data(plan.qs, (4, plan.n), logn, dtype)
    fns = (lambda v, p: jfr.rns_fourstep_ntt_lanes(v, p, mod_idx),
           lambda v, p: jfr.rns_fourstep_intt_lanes(v, p, mod_idx),
           lambda v, p: jfr.rns_fourstep_intt_lanes(v, p, mod_idx, scale=False),
           lambda v, p: jfr.rns_fourstep_ntt_full(v, p, mod_idx),
           lambda v, p: jfr.rns_fourstep_intt_full(v, p, mod_idx))
    # the _full entries only where they cost no second compile of the
    # 4-step sweeps (u32); the golden test below holds them at logn 14
    fns = fns if not is64 else fns[:3]
    want = jax.jit(lambda v, p: tuple(f(v, p) for f in fns))(jto(x, is64), jplan)
    hr.reset_counts()
    got = _port(to_lanes(x, is64), plan, mod_idx)
    for name, g, w in zip(ENTRIES, got, want):
        np.testing.assert_array_equal(from_lanes(g, is64), jfrom(w, is64), err_msg=name)
    assert tfr.covers(plan) == (route is not None)
    if route:
        # the column kernel for every entry but scale=False; the rows on
        # K13's row kernel or K12
        assert hr.FOURSTEP_COL.plain_calls == 4
        rows = (hr.LARGE_ROWMAT.plain_calls if route == "K13-row"
                else hr.FORWARD.plain_calls + hr.INVERSE.plain_calls)
        assert rows == 4
    # scale=False ran the engine, which built W for the members it used
    assert "w" in plan.members[0]._lazy and "w" in plan.members[-1]._lazy


@pytest.mark.parametrize("logn,poly", [(14, PLUS), (14, MINUS), (18, PLUS)])
def test_full_entries_match_golden(logn, poly):
    members = ladder(tg, logn, 2, poly, np.uint64)
    plan = tg.RNSFourStepPlan.from_params(members, device="cpu")
    gens = [tg.NTT4StepCPU(p) for p in members]
    mod_idx = np.array([1, 0])
    x = data(plan.qs, (2, plan.n), logn, np.uint64)
    fx = from_lanes(tg.rns_fourstep_ntt_full(to_lanes(x, True), plan, mod_idx), True)
    np.testing.assert_array_equal(fx, np.stack([gens[m].ntt(x[b])
                                                for b, m in enumerate(mod_idx)]))
    back = tg.rns_fourstep_intt_full(to_lanes(fx, True), plan, mod_idx)
    np.testing.assert_array_equal(from_lanes(back, True), x)
    assert all("w" not in m._lazy for m in plan.members)  # the kernel route built none


# ----------------------------------------------------------- plans, routes


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_from_arrays_equals_from_params(dtype):
    """A port plan carried across from a JAX RNSFourStepPlan's stacked
    arrays (W tables included) gives what from_params gives."""
    jplan, own = plans(dtype, 14, MINUS, 3 if dtype == np.uint32 else 2)
    arr = u64_to_numpy if dtype == np.uint64 else np.asarray
    ms = jplan.members
    carried = tg.RNSFourStepPlan.from_arrays(
        jplan.qs, jplan.logn, jplan.n1, jplan.n2, MINUS, [m.root_of_unity for m in ms],
        [m.inverse_root_of_unity for m in ms], [m.n_inv for m in ms], arr(jplan.n1_fwd),
        arr(jplan.n2_fwd), arr(jplan.n1_inv), arr(jplan.n2_inv), arr(jplan.w_fwd),
        arr(jplan.w_inv), device="cpu", dtype=dtype)
    assert (carried.logn, carried.n1, carried.n2, carried.qs, carried.is64) == (
        own.logn, own.n1, own.n2, own.qs, own.is64)
    for c, o in zip(carried.members, own.members):
        for name in ("n1_fwd", "n1_fwd_sh", "n2_fwd", "n2_inv_sh"):
            assert torch.equal(getattr(c, name), getattr(o, name)), name
        assert "w" in c._lazy
    x = to_lanes(data(own.qs, (2, own.n), 1, dtype), dtype == np.uint64)
    for a, b in zip(_port(x, carried, [1, 0]), _port(x, own, [1, 0])):
        assert torch.equal(a, b)
    for a, b in zip(carried.members[0].w_tables(), own.members[0].w_tables()):
        assert torch.equal(a, b)


def test_plans_refuse_mixed_members():
    a = ladder(tg, 14, 1, MINUS, np.uint64)[0]
    for b in (ladder(tg, 15, 1, MINUS, np.uint64)[0], ladder(tg, 14, 1, MINUS, np.uint32)[0],
              tg.NTTParameters4Step(14, tg.ReductionPolynomial.X_N_minus, np.uint64,
                                    dims=(64, 256))):
        with pytest.raises(ValueError):
            tg.RNSFourStepPlan.from_params([a, b], device="cpu")


def test_route_table():
    def covered(logn, dtype=np.uint64, bits=None):
        return tfr.covers(tg.RNSFourStepPlan.from_params(ladder(tg, logn, 2, MINUS, dtype, bits),
                                                         device="cpu"))

    assert [covered(k) for k in (12, 13, 14, 18, 23, 24)] == [False, False, True, True, True,
                                                              False]
    assert covered(14, bits=62) and not covered(14, bits=63)
    assert not covered(14, np.uint32) and not covered(20, np.uint32)


def test_kernel_plan_at_2_18_builds_no_w_table():
    plan = tg.RNSFourStepPlan.from_params(ladder(tg, 18, 2, PLUS, np.uint64), device="cpu")
    sp = hr.fourstep_plan(plan)
    assert hr.fourstep_plan(plan) is sp
    kp = sp.first
    assert (kp.n1, kp.n2, kp.row_kernel) == (32, 8192, "K1")
    assert all("w" not in m._lazy and "kernel" not in m._lazy for m in plan.members)
    assert max(t[0].numel() for t in (sp.wt_fwd, sp.ws_fwd, sp.rows.fwd_tables,
                                      sp.col.fwd_tables)) <= 1 << 12
    moved = plan.to("meta")
    assert moved.members[0].n1_fwd.device == torch.device("meta")
    assert moved._lazy["kernel"].rows.fwd_tables.device == torch.device("meta")
    assert plan.to("cpu") is plan


def test_plan_defaults_to_the_card():
    members = ladder(tg, 14, 2, MINUS, np.uint64)
    if torch.cuda.is_available():
        assert tg.RNSFourStepPlan.from_params(members).device.type == "cuda"
    else:
        with pytest.raises(tg.NTTDeviceError):
            tg.RNSFourStepPlan.from_params(members)
