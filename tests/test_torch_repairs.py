"""The port's RNS schedules and routing arguments against gpuntt_tpu's
lanes entries (CPU, exact equality).

- F1: rns_pointwise_mult_lanes on a schedule of one entry for every row
  (u64, logn 14, X^N - 1, a ladder of 3, four rows, [2]), and on
  schedules of other lengths, where the JAX where-chain broadcasts or
  fails; no row comes back unwritten.
- F2: one schedule entry for several rows in ntt_rns_lanes /
  intt_rns_lanes (on the kernels' route), rns_ntt_lanes /
  rns_intt_lanes (the engine) and rns_fourstep_ntt_lanes /
  rns_fourstep_intt_lanes (u64 logn 14 RNS 4-step, four rows, [2];
  u64 logn 12 merge RNS, three rows, [1]; ladders of 3), and the one
  error for every other length.
- F3: `use_pallas` on ntt_lanes / intt_lanes / polymul_lanes, read as
  the JAX package reads it (its outputs on use_pallas=False, the XLA
  engine), with the route each value takes counted on the kernels'
  plain versions ("vpu" on u64: K15's counterpart);
  PolynomialMultiplier.step_lanes.
- Every callable in gpuntt_tpu.__all__ has its parameters in the port.
"""

import dataclasses
import functools
import inspect

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import dispatch as jd
from gpuntt_tpu.ops import fourstep_rns as jf
from gpuntt_tpu.ops import rns as jr
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import rns as trns
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus


def ladder(pkg, logn, poly, four=False):
    """A ladder of 3 from find_ntt_primes(59, logn, 3)."""
    out = []
    for q in pkg.find_ntt_primes(59, logn, 3):
        omega, psi = pkg.ntt_root_pair(q, logn)
        params = pkg.NTTParameters4Step if four else pkg.NTTParameters
        out.append(params(logn, pkg.ReductionPolynomial(poly.value), np.uint64,
                          factors=pkg.NTTFactors(pkg.Modulus64(q), omega, psi)))
    return out


def data(qs, rows, n, seed):
    return np.random.default_rng(seed).integers(0, min(qs), size=(rows, n), dtype=np.uint64)


def jax_result(fn, *args):
    """fn's output as numpy, or the exception it raised."""
    try:
        return jfrom(fn(*args), True)
    except Exception as e:  # noqa: BLE001 — the JAX package's error is the reference
        return e


def same_as_jax(want, port_fn):
    """The port's call gives the JAX call's rows, or raises where it
    raised, with an error of the same type."""
    if isinstance(want, Exception):
        with pytest.raises(type(want)):
            port_fn()
        with pytest.raises(tg.NTTScheduleError):
            port_fn()
    else:
        np.testing.assert_array_equal(from_lanes(port_fn(), True), want)


# ------------------------------------------------------------------- F1


@pytest.mark.parametrize("rows,mod_idx", [(4, [2]), (4, [1, 2]), (4, [2, 0, 1, 1, 0]),
                                          (4, []), (1, [0, 2, 1])])
def test_f1_pointwise_lanes_schedule_broadcast(rows, mod_idx):
    """[2] serves all four rows; a schedule of 2, 5 or 0 entries for four
    rows fails to broadcast in JAX (ValueError), and one of three entries
    over one row gives three rows."""
    jplan = jg.RNSMergePlan.from_params(ladder(jg, 14, MINUS))
    plan = tg.RNSMergePlan.from_params(ladder(tg, 14, MINUS), device="cpu")
    a, b = data(plan.qs, rows, plan.n, 1), data(plan.qs, rows, plan.n, 2)
    m = np.array(mod_idx, dtype=np.int64)
    want = jax_result(jax.jit(lambda u, v: jd.rns_pointwise_mult_lanes(u, v, jplan, m)),
                      jto(a, True), jto(b, True))
    same_as_jax(want, lambda: tg.rns_pointwise_mult_lanes(to_lanes(a, True),
                                                          to_lanes(b, True), plan, m))


def test_f1_per_modulus_writes_every_row():
    plan = tg.RNSMergePlan.from_params(ladder(tg, 14, MINUS), device="cpu")
    x = to_lanes(data(plan.qs, 4, plan.n, 3), True)
    for bad in ([2], [0, 1, 2], [0, 1, 2, 3], [0, 1, -1, 2]):  # short, or naming no member
        with pytest.raises(tg.NTTScheduleError):
            trns.per_modulus(lambda v, m: v, plan.members, np.array(bad), x)


# ------------------------------------------------------------------- F2


@pytest.mark.parametrize("mod_idx", [[1], [1, 2], [0, 1, 2, 0], []])
def test_f2_merge_rns_schedule_broadcast(mod_idx):
    """u64 logn 12, three rows: [1] serves them all on the kernels' route
    (K12's plain versions, one entry per ring) and on the engine; other
    lengths raise one error, a TypeError as in JAX."""
    jplan = jg.RNSMergePlan.from_params(ladder(jg, 12, PLUS))
    plan = tg.RNSMergePlan.from_params(ladder(tg, 12, PLUS), device="cpu")
    x = data(plan.qs, 3, plan.n, 4)
    m = np.array(mod_idx, dtype=np.int64)
    for jfn, entries in ((jr.rns_ntt_lanes, (td.ntt_rns_lanes, trns.rns_ntt_lanes)),
                         (jr.rns_intt_lanes, (td.intt_rns_lanes, trns.rns_intt_lanes))):
        want = jax_result(jax.jit(lambda v, mi, jfn=jfn: jfn(v, jplan, mi)), jto(x, True), m)
        for fn in entries:
            tracing.reset()
            same_as_jax(want, lambda fn=fn: fn(to_lanes(x, True), plan, m))
            if fn.__module__.endswith("dispatch") and not isinstance(want, Exception):
                assert hr.FORWARD.plain_calls + hr.INVERSE.plain_calls == 1
    if len(mod_idx) == 1:
        y = data(plan.qs, 3, plan.n, 5)
        got = td.rns_polymul_lanes(to_lanes(x, True), to_lanes(y, True), plan, m)
        full = np.repeat(m, 3)
        np.testing.assert_array_equal(
            from_lanes(got, True),
            from_lanes(td.rns_polymul_lanes(to_lanes(x, True), to_lanes(y, True), plan, full),
                       True))


@pytest.mark.parametrize("mod_idx", [[2], [1, 2], [2, 0, 1, 1, 0]])
def test_f2_fourstep_rns_schedule_broadcast(mod_idx):
    """u64 logn 14 RNS 4-step, four rows: [2] reaches K14's plain versions
    as a full schedule; other lengths raise as in JAX."""
    jplan = jf.RNSFourStepPlan.from_params(ladder(jg, 14, MINUS, four=True))
    plan = tg.RNSFourStepPlan.from_params(ladder(tg, 14, MINUS, four=True), device="cpu")
    x = data(plan.qs, 4, plan.n, 6)
    m = np.array(mod_idx, dtype=np.int64)
    for jfn, fn in ((jf.rns_fourstep_ntt_lanes, tg.rns_fourstep_ntt_lanes),
                    (jf.rns_fourstep_intt_lanes, tg.rns_fourstep_intt_lanes)):
        # the JAX 4-step reads its schedule on the host: a constant here
        want = jax_result(jax.jit(lambda v, jfn=jfn: jfn(v, jplan, m)), jto(x, True))
        tracing.reset()
        same_as_jax(want, lambda fn=fn: fn(to_lanes(x, True), plan, m))
        if not isinstance(want, Exception):
            assert hr.FOURSTEP_COL.plain_calls == 1


# ------------------------------------------------------------------- F3


def operands(p):
    """Two (2, N) operands of canonical residues for the plan's q."""
    return [data((p.modulus.value,), 2, p.n, seed).astype(p.dtype) for seed in (7, 8)]


@functools.cache
def jax_merge_ref(dtype):
    """(x, y, ntt_lanes(x), polymul_lanes(x, y)) at logn 12, X^N + 1, the
    pool prime: the JAX entries with use_pallas=False (the XLA engine),
    under one jit per word size."""
    p = jg.NTTParameters(12, PLUS, dtype)
    jplan, is64 = jg.MergePlan.from_params(p), dtype == np.uint64
    x, y = operands(p)
    ref = jax.jit(lambda u, v: (jd.ntt_lanes(u, jplan, use_pallas=False),
                                jd.polymul_lanes(u, v, jplan, use_pallas=False)))
    return x, y, *(jfrom(r, is64) for r in ref(jto(x, is64), jto(y, is64)))


def _counts():
    ks = (*hm.KERNELS, *hml.KERNELS, *hm32.KERNELS, *hk64.KERNELS)
    return {k.name: k.plain_calls for k in ks if k.plain_calls}


@pytest.mark.parametrize("dtype,logn,use_pallas,fwd", [
    (np.uint64, 12, "auto", {"merge_u64_forward"}),
    (np.uint64, 12, True, {"merge_u64_forward"}),
    (np.uint64, 12, False, set()),
    (np.uint64, 12, "mxu", {"merge_u64_forward"}),
    (np.uint64, 12, "mxu-large", set()),       # the big-ring route takes logn 18-28
    (np.uint64, 12, "mxu32", set()),           # a u32 path on a u64 plan
    (np.uint64, 18, "mxu-large", {"merge_u64_large_colfwd", "merge_u64_forward"}),
    (np.uint32, 12, "vpu", {"merge_u32_forward_k4"}),
    (np.uint32, 12, "mxu32", {"merge_u32_forward_k4"}),
    (np.uint32, 12, True, {"merge_u32_forward_k4"}),
    (np.uint32, 18, "mxu32-large", {"merge_u32_forward_k6"}),
    (np.uint32, 12, False, set()),
    (np.uint64, 12, "vpu", {"kmerge_u64_forward"}),  # K15's counterpart
])
def test_f3_use_pallas_routes(dtype, logn, use_pallas, fwd):
    """Each value's route, by the plain versions its forward ran (none:
    the engine), and its outputs: at logn 12 against the JAX entries on
    the XLA engine (use_pallas=False), at 18 against the port's engine.
    A value other than "auto" leaves the polymul's product unfused, as in
    the JAX package."""
    poly = tg.ReductionPolynomial.X_N_plus
    p = tg.NTTParameters(logn, poly, dtype)
    plan = tg.MergePlan.from_params(p, device="cpu")
    is64 = dtype == np.uint64
    x, y = (to_lanes(v, is64) for v in operands(p))
    if logn == 12:
        want = jax_merge_ref(dtype)[2:]
    else:
        want = [from_lanes(tg.ntt_lanes(x, plan, use_pallas=False), is64),
                from_lanes(tg.polymul_lanes(x, y, plan, use_pallas=False), is64)]
    tracing.reset()
    fx = tg.ntt_lanes(x, plan, use_pallas=use_pallas)
    assert set(_counts()) == fwd
    np.testing.assert_array_equal(from_lanes(fx, is64), want[0])
    assert torch.equal(tg.intt_lanes(fx, plan, use_pallas=use_pallas), x)
    tracing.reset()
    got = tg.polymul_lanes(x, y, plan, use_pallas=use_pallas)
    np.testing.assert_array_equal(from_lanes(got, is64), want[1])
    assert ("merge_u64_polymul_inverse" in _counts()) == (use_pallas == "auto" and is64)


def test_f3_vpu_on_u64_names_k15():
    """use_pallas="vpu" on a u64 plan runs K15's counterpart (its plain
    version here) in every entry, and gives the JAX package's outputs (the
    XLA engine's, which its K15 equals; tests/test_torch_kmerge.py holds
    the plain version against K15 itself in interpret mode)."""
    plan = tg.MergePlan.from_params(tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus,
                                                     np.uint64), device="cpu")
    x_np, y_np, fx_want, prod_want = jax_merge_ref(np.uint64)
    x, y = to_lanes(x_np, True), to_lanes(y_np, True)
    tracing.reset()
    fx = tg.ntt_lanes(x, plan, use_pallas="vpu")
    np.testing.assert_array_equal(from_lanes(fx, True), fx_want)
    assert torch.equal(tg.intt_lanes(fx, plan, use_pallas="vpu"), x)
    np.testing.assert_array_equal(
        from_lanes(tg.polymul_lanes(x, y, plan, use_pallas="vpu"), True), prod_want)
    assert _counts() == {"kmerge_u64_forward": 3, "kmerge_u64_inverse": 2}


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_f3_step_lanes(dtype):
    """PolynomialMultiplier.step_lanes is polymul_lanes on the module's
    plan, as the JAX model's is (gpuntt_tpu/models/polymul.py:48-55):
    its output is the JAX polymul_lanes's."""
    model = tg.PolynomialMultiplier(tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus,
                                                     dtype), device="cpu")
    is64 = dtype == np.uint64
    x, y, _, want = jax_merge_ref(dtype)
    got = model.step_lanes(to_lanes(x, is64), to_lanes(y, is64))
    np.testing.assert_array_equal(from_lanes(got, is64), want)
    assert torch.equal(got, model(to_lanes(x, is64), to_lanes(y, is64)))


# ------------------------------------------------------------ the surface


def test_every_jax_callable_has_its_parameters_in_the_port():
    """For each callable name in gpuntt_tpu.__all__, the port has the
    same name and every parameter of the JAX signature (the port may add
    its own, such as `device`): a function's, a class's constructor and
    each public method the two classes share.  A plan's dataclass fields
    are its device tables in each package's own layout, built through
    from_params / from_arrays, so a dataclass's constructor is left out."""
    lacking = {}

    def compare(what, a, b):
        try:
            want = inspect.signature(a).parameters
        except (TypeError, ValueError):  # builtins and enums without a signature
            return
        if missing := [p for p in want if p not in inspect.signature(b).parameters]:
            lacking[what] = missing

    for name in jg.__all__:
        obj = getattr(jg, name)
        if not callable(obj):
            continue
        assert hasattr(tg, name), f"the port lacks {name}"
        ported = getattr(tg, name)
        if not inspect.isclass(obj):
            compare(name, obj, ported)
            continue
        if not dataclasses.is_dataclass(obj):
            compare(name, obj, ported)
        for attr, member in vars(obj).items():
            if attr.startswith("_"):
                continue
            member = getattr(member, "__func__", member)
            theirs = inspect.getattr_static(ported, attr, None)
            theirs = getattr(theirs, "__func__", theirs)
            if inspect.isfunction(member) and inspect.isfunction(theirs):
                compare(f"{name}.{attr}", member, theirs)
    assert not lacking, lacking
