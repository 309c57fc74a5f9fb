"""The port's 4-step path against gpuntt_tpu's (CPU, exact equality).

- The public entries (fourstep_ntt_lanes, fourstep_intt_lanes with and
  without its scaling, fourstep_ntt_full, fourstep_intt_full,
  transpose_lanes) against the JAX package's on its XLA engine, u64 and
  u32, both reduction polynomials, logn 12, 13, 16 and 17 at batch 1-3,
  a 3-D batch, and u64 logn 20.  The port takes device="cpu", so its
  kernels' plain versions run through the same route and composition.
- The `_full` entries against the golden NTT4StepCPU at logn 14 and 18,
  and custom splits on both sides of the row rule.
- The kernels' plain versions against the Pallas kernels they replace
  (interpret mode): K9 (mod q, its output is lazy) at logn 12 and 13,
  K10, K11's column and row twins at 12, and the row delegation at a
  lowered ROW_MATMUL_MAX.
- The converter FourStepPlan.from_arrays, the route table, the plan's
  memory at 2^24, the u32 row kernels at logn 7, the wrappers' contract.

Inputs are canonical residues from numpy seeds; nothing above logn 20
is transformed here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import fourstep as jf
from gpuntt_tpu.ops.limb import u64_to_numpy
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import fourstep as tf
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes
from gpuntt_tpu_torch.reference.fourstep_cpu import intt_input_indices

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus
POLYS = [MINUS, PLUS]


def both(logn, poly, dtype, dims=None, bits=None):
    """The JAX package's NTTParameters4Step and the port's, alike; `bits`
    picks a found prime of that size (with its root pair) over the pool."""
    jkw, tkw = {}, {}
    if bits is not None:
        q = jg.find_ntt_primes(bits, logn, 1)[0]
        omega, psi = jg.ntt_root_pair(q, logn)
        mod = (jg.Modulus64, tg.Modulus64) if dtype == np.uint64 else (jg.Modulus32,
                                                                        tg.Modulus32)
        jkw["factors"] = jg.NTTFactors(mod[0](q), omega, psi)
        tkw["factors"] = tg.NTTFactors(mod[1](q), omega, psi)
    jp = jg.NTTParameters4Step(logn, poly, dtype, dims=dims, **jkw)
    tp = tg.NTTParameters4Step(logn, tg.ReductionPolynomial(poly.value), dtype, dims=dims,
                               **tkw)
    return jp, tp


def data(p, shape, seed):
    return np.random.default_rng(seed).integers(0, p.modulus.value, size=shape,
                                                 dtype=np.uint64).astype(p.dtype)


def lanes(x):
    return to_lanes(x, x.dtype == np.uint64)


def unlanes(t, dtype):
    return from_lanes(t, dtype == np.uint64)


# ------------------------------------------------- entries against JAX


@jax.jit
def _jax_entries(v, plan):
    """Every 4-step entry of the JAX package, one compile per shape and
    plan numbers (the plan rides as a pytree argument)."""
    return (jf.fourstep_ntt_lanes(v, plan), jf.fourstep_intt_lanes(v, plan),
            jf.fourstep_intt_lanes(v, plan, scale=False), jf.fourstep_ntt_full(v, plan),
            jf.fourstep_intt_full(v, plan), jf.transpose_lanes(v, plan.n1, plan.n2))


def _port_entries(x, plan):
    return (tg.fourstep_ntt_lanes(x, plan), tg.fourstep_intt_lanes(x, plan),
            tg.fourstep_intt_lanes(x, plan, scale=False), tg.fourstep_ntt_full(x, plan),
            tg.fourstep_intt_full(x, plan), tg.transpose_lanes(x, plan.n1, plan.n2))


def check_entries(jp, tp, shape, seed):
    x = data(jp, shape, seed)
    # params=None: the XLA engine does not read them, and both
    # polynomials of one pool prime then share one compile
    jplan = dataclasses.replace(jf.FourStepPlan.from_params(jp), params=None)
    want = [jfrom(o, jp.dtype == np.uint64) for o in _jax_entries(jto(x, jp.dtype == np.uint64),
                                                                   jplan)]
    plan = tg.FourStepPlan.from_params(tp, device="cpu")
    hf.reset_counts()
    got = [unlanes(o, tp.dtype) for o in _port_entries(lanes(x), plan)]
    for name, g, w in zip(("ntt_lanes", "intt_lanes", "intt_lanes(scale=False)", "ntt_full",
                           "intt_full", "transpose_lanes"), got, want):
        np.testing.assert_array_equal(g, w.astype(tp.dtype).reshape(shape), err_msg=name)
    return plan


ENTRY_CELLS = [(logn, dtype, poly, 1 + i % 3)
               for i, logn in enumerate((12, 13, 16, 17))
               for dtype in (np.uint64, np.uint32) for poly in POLYS]


@pytest.mark.parametrize("logn,dtype,poly,batch", ENTRY_CELLS)
def test_entries_match_jax(logn, dtype, poly, batch):
    jp, tp = both(logn, poly, dtype)
    plan = check_entries(jp, tp, (batch, jp.n), logn + batch)
    # the route ran the kernels' plain versions: the column phase for
    # ntt_lanes, intt_lanes and the two _full entries, and the rows
    col = hf.COL64 if plan.is64 else hf.COL32
    assert hf.covers(plan) and col.plain_calls == 4
    row = hf.ROW64 if plan.is64 else hf.ROW32
    assert row.plain_calls == (4 if plan.n2 <= 512 else 0)


def test_entries_match_jax_on_a_3d_batch():
    jp, tp = both(13, PLUS, np.uint32)
    check_entries(jp, tp, (2, 2, jp.n), 3)


def test_entries_match_jax_at_logn_20():
    jp, tp = both(20, MINUS, np.uint64)
    hm.reset_counts()
    check_entries(jp, tp, (1, jp.n), 20)
    # rows of 2^15 on K1/K2: two forwards, two inverses
    assert [k.plain_calls for k in hm.KERNELS] == [2, 2, 0]


# ------------------------------------------------------- golden model


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("logn,poly", [(14, PLUS), (14, MINUS), (18, PLUS)])
def test_full_entries_match_golden(logn, poly, dtype):
    jp, tp = both(logn, poly, dtype)
    gen = jg.NTT4StepCPU(jp)
    plan = tg.FourStepPlan.from_params(tp, device="cpu")
    x = data(jp, (2, jp.n), logn)
    fx = unlanes(tg.fourstep_ntt_full(lanes(x), plan), dtype)
    np.testing.assert_array_equal(fx, np.stack([gen.ntt(r) for r in x]))
    np.testing.assert_array_equal(unlanes(tg.fourstep_intt_full(lanes(x), plan), dtype),
                                  np.stack([gen.intt(r) for r in x]))
    np.testing.assert_array_equal(unlanes(tg.fourstep_intt_full(lanes(fx), plan), dtype), x)


@pytest.mark.parametrize("dtype,dims,route", [
    (np.uint64, (8, 2048), True),    # rows of 2^11 on K1/K2
    (np.uint64, (16, 1024), False),  # u64 rows of 1024 have no kernel: the engine
    (np.uint32, (128, 128), True),   # rows of 128 on K11's row twin
    (np.uint32, (256, 64), False),   # u32 rows of 64: the engine
    (np.uint64, (1024, 16), False),  # n1 past the column kernels' 512
])
def test_custom_dims_on_both_sides_of_the_row_rule(dtype, dims, route):
    logn = (dims[0] * dims[1]).bit_length() - 1
    jp, tp = both(logn, PLUS, dtype, dims=dims)
    gen = jg.NTT4StepCPU(jp)
    plan = tg.FourStepPlan.from_params(tp, device="cpu")
    assert hf.covers(plan) == route
    x = data(jp, (2, jp.n), 5)
    hf.reset_counts()
    fx = unlanes(tg.fourstep_ntt_full(lanes(x), plan), dtype)
    np.testing.assert_array_equal(fx, np.stack([gen.ntt(r) for r in x]))
    np.testing.assert_array_equal(unlanes(tg.fourstep_intt_full(lanes(fx), plan), dtype), x)
    assert sum(k.plain_calls for k in hf.KERNELS) == (4 if route and dims[1] <= 512 else
                                                     2 if route else 0)
    assert ("w" in plan._lazy) == (not route)  # the engine built its W tables


def test_intt_permutation_is_a_transpose():
    n1, n2 = 32, 128
    x = torch.arange(3 * n1 * n2).reshape(3, -1)
    assert torch.equal(tg.transpose_lanes(x, n2, n1),
                       x[:, torch.from_numpy(intt_input_indices(n1, n2))])


# ---------------------------------------- kernels' plain versions vs Pallas


def _mxu_plans(logn, dtype):
    from gpuntt_tpu.ops import pallas_mxu_4step as m4

    jp, tp = both(logn, MINUS, dtype)
    mp = (m4.FourStepMXUPlan if dtype == np.uint64 else m4.FourStep32MXUPlan).from_params(jp)
    return m4, jp, mp, hf.kernel_plan(tg.FourStepPlan.from_params(tp, device="cpu"))


@pytest.mark.parametrize("logn,dtype", [(12, np.uint64), (13, np.uint64), (12, np.uint32)])
def test_col_plain_matches_pallas_col(logn, dtype):
    """K9 (u64) at logn 12 and 13, K11's column twin (u32) at 12.  The
    Pallas outputs are lazy, so they are compared mod q."""
    m4, jp, mp, kp = _mxu_plans(logn, dtype)
    q, n1, n2 = jp.modulus.value, jp.n1, jp.n2
    x = data(jp, (2, jp.n), logn)
    run = m4._run_col if dtype == np.uint64 else m4._run_col32
    for inverse in (False, True):
        want = jfrom(run(jto(x.reshape(2, n2, n1), dtype == np.uint64), mp, inverse,
                         interpret=True), dtype == np.uint64)
        want = want.astype(np.uint64) % np.uint64(q)
        got = unlanes(hf.col_plain(lanes(x), kp, inverse), dtype)
        np.testing.assert_array_equal(got, want.reshape(2, -1).astype(dtype))


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_row_plain_matches_pallas_row(dtype):
    """K10 (u64) and K11's row twin (u32) at logn 12: rows of 128."""
    m4, jp, mp, kp = _mxu_plans(12, dtype)
    n1, n2 = jp.n1, jp.n2
    x = data(jp, (2, jp.n), 7)
    run = m4._run_row_matmul if dtype == np.uint64 else m4._run_row32_matmul
    plain = hml.rowmat_plain if dtype == np.uint64 else hf.row32_plain
    for inverse in (False, True):
        want = jfrom(run(jto(x.reshape(2, n1, n2), dtype == np.uint64), mp, inverse,
                         interpret=True), dtype == np.uint64)
        got = unlanes(plain(lanes(x.reshape(-1, n2)), kp.rows, inverse), dtype)
        np.testing.assert_array_equal(got, want.reshape(-1, n2))


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_row_delegation_matches_pallas(dtype, monkeypatch):
    """Rows above ROW_MATMUL_MAX go to the merge kernels (the production
    path from logn 17), here with both thresholds lowered to 64 so that
    logn 12's rows of 128 take it in interpret mode.  u64: the whole
    transform.  u32: the JAX column kernel, then its delegated rows on
    4 of the 32 rows (the interpreted u32 row kernel takes about a
    second a row), against the same rows of the port's transform."""
    m4, jp, _, kp = _mxu_plans(12, dtype)
    monkeypatch.setattr(m4, "ROW_MATMUL_MAX", 64)
    monkeypatch.setattr(hf, "ROW_MAT_MAX", 64)
    is64 = dtype == np.uint64
    mp = (m4.FourStepMXUPlan if is64 else m4.FourStep32MXUPlan).from_params(jp)
    assert mp.row_plan is not None
    x = data(jp, (2 if is64 else 1, jp.n), 9)
    for inverse in (False, True):
        got = unlanes(hf.fourstep_plain(lanes(x), kp, inverse), dtype)
        if is64:
            want = jfrom(m4.fourstep_mxu_lanes(jto(x, True), mp, inverse=inverse,
                                               interpret=True), True)
            np.testing.assert_array_equal(got, want)
            continue
        from gpuntt_tpu.ops.pallas_mxu32 import pallas_mxu_u32

        cols = m4._run_col32(x.reshape(1, jp.n2, jp.n1), mp, inverse, interpret=True)
        rows = np.asarray(cols).reshape(-1, jp.n2)[:4]
        want = np.asarray(pallas_mxu_u32(rows, mp.row_plan, inverse=inverse, interpret=True))
        np.testing.assert_array_equal(got.reshape(-1, jp.n2)[:4], want)


# -------------------------------------------------------- plans, routes


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_from_arrays_equals_from_params(dtype):
    """A port plan carried across from a JAX FourStepPlan's arrays (W
    tables included) gives what from_params gives, on the kernel route
    and on the engine."""
    jp, tp = both(13, PLUS, dtype)
    jplan = jf.FourStepPlan.from_params(jp)
    arr = u64_to_numpy if dtype == np.uint64 else np.asarray
    carried = tg.FourStepPlan.from_arrays(
        jplan.q, jplan.logn, jplan.n1, jplan.n2, jp.poly_reduction, jp.root_of_unity,
        jp.inverse_root_of_unity, jp.n_inv, arr(jplan.n1_fwd), arr(jplan.n2_fwd),
        arr(jplan.n1_inv), arr(jplan.n2_inv), arr(jplan.w_fwd), arr(jplan.w_inv),
        device="cpu", dtype=dtype)
    own = tg.FourStepPlan.from_params(tp, device="cpu")
    for name in tf._TABLES:
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    assert "w" in carried._lazy and "w" not in own._lazy
    x = lanes(data(jp, (2, jp.n), 1))
    for a, b in zip(_port_entries(x, carried), _port_entries(x, own)):
        assert torch.equal(a, b)
    for a, b in zip(carried.w_tables(), own.w_tables()):  # own builds its W now
        assert torch.equal(a, b)


def test_route_table():
    for dtype in (np.uint64, np.uint32):
        for poly in POLYS:
            for logn in range(12, 25):
                plan = tg.FourStepPlan.from_params(both(logn, poly, dtype)[1], device="cpu")
                assert hf.covers(plan), (logn, dtype, poly)
    # q >= 2^62 (u64) or 2^30 (u32): the engine
    for dtype, bits in ((np.uint64, 63), (np.uint32, 31)):
        plan = tg.FourStepPlan.from_params(both(12, PLUS, dtype, bits=bits)[1], device="cpu")
        assert not hf.covers(plan)
    plan = tg.FourStepPlan.from_params(both(12, PLUS, np.uint64, bits=62)[1], device="cpu")
    assert hf.covers(plan)
    # factors that are no root of unity: the engine
    odd = tg.NTTParameters4Step(12, tg.ReductionPolynomial.X_N_plus, np.uint64,
                                factors=tg.NTTFactors(tg.Modulus64(576460752303415297), 5, 7))
    assert not hf.covers(tg.FourStepPlan.from_params(odd, device="cpu"))
    # the row rule at the rows' edges, u64 and u32
    assert [hf.rows_have_kernel(1 << k, True) for k in (9, 10, 11, 17, 18)] == \
        [True, False, True, True, False]
    assert [hf.rows_have_kernel(1 << k, False) for k in (6, 7, 9, 10, 25, 26)] == \
        [False, True, True, True, True, False]


def test_non_root_factors_take_the_engine():
    jp = jg.NTTParameters4Step(12, PLUS, np.uint64, factors=jg.NTTFactors(
        jg.Modulus64(576460752303415297), 5, 7))
    tp = tg.NTTParameters4Step(12, tg.ReductionPolynomial.X_N_plus, np.uint64,
                               factors=tg.NTTFactors(tg.Modulus64(576460752303415297), 5, 7))
    hf.reset_counts()
    check_entries(jp, tp, (1, jp.n), 4)  # shares the logn-12 cell's compile
    assert sum(k.plain_calls for k in hf.KERNELS) == 0


def test_kernel_plan_at_2_24_touches_no_w_table():
    """At 2^24 the kernel plan is exponent algebra: the parameters' W
    tables (512 MiB as the JAX plan holds them) are never built, and no
    table of the plan has more than 2^16 entries."""
    p = tg.NTTParameters4Step(24, tg.ReductionPolynomial.X_N_minus, np.uint64)
    plan = tg.FourStepPlan.from_params(p, device="cpu")
    kp = hf.kernel_plan(plan)
    assert p._w_forward is None and p._w_inverse is None and "w" not in plan._lazy
    assert (kp.n1, kp.n2, kp.tile, kp.w_tile, kp.row_kernel) == (256, 1 << 16, 16, 256, "K1")
    sizes = [t.numel() for t in (kp.wt_fwd, kp.ws_fwd, kp.wt_inv, kp.ws_inv,
                                 kp.rows.fwd_table, kp.col.fwd_table)]
    assert max(sizes) <= 1 << 16
    assert kp.device_bytes() == 8 * (8 * (256 * 256) + 4 * (128 + 32768))
    assert hf.kernel_plan(plan) is kp
    assert hf.kernel_plan(plan.to("meta")).device == torch.device("meta")


# ---------------------------------------------------------- u32 rows at 7


def test_u32_family_takes_logn_7():
    """The 4-step's rows of 128 words: `takes` admits logn 7, dispatch's
    `covers` does not, and the launches count under the stats given."""
    p = tg.NTTParameters(7, tg.ReductionPolynomial.X_N_minus, np.uint32)
    plan = tg.MergePlan.from_params(p, device="cpu")
    assert hm32.takes(plan) and not hm32.covers(plan)
    assert not hm32.takes(tg.MergePlan.from_params(
        tg.NTTParameters(6, tg.ReductionPolynomial.X_N_minus, np.uint32), device="cpu"))
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 1 << 32, size=(3, p.n)))
    hm32.reset_counts()
    hf.reset_counts()
    gen = tg.NTTCPU(p)
    xr = x.numpy().astype(np.uint32) % np.uint32(p.modulus.value)
    fx = hf.fourstep_u32_row(x, plan, False)
    np.testing.assert_array_equal(fx.numpy().astype(np.uint32), gen.ntt(xr))
    np.testing.assert_array_equal(hf.fourstep_u32_row(fx, plan, True).numpy(), xr)
    assert hf.ROW32.plain_calls == 2 and sum(k.plain_calls for k in hm32.KERNELS) == 0
    with pytest.raises(tg.NTTDispatchError):  # 2^10 rows are the u32 family's, not K11's
        p10 = tg.NTTParameters(10, tg.ReductionPolynomial.X_N_minus, np.uint32)
        hf.fourstep_u32_row(torch.zeros((1, p10.n), dtype=torch.int64),
                            tg.MergePlan.from_params(p10, device="cpu"), False)


# ------------------------------------------------------ wrapper contract


def test_wrappers_take_plain_versions_on_cpu_only():
    jp, tp = both(12, PLUS, np.uint64)
    plan = tg.FourStepPlan.from_params(tp, device="cpu")
    kp = hf.kernel_plan(plan)
    x = lanes(data(jp, (2, jp.n), 2))
    hf.reset_counts()
    y = hf.fourstep_u64_col(x, kp, False)
    hf.fourstep_u64_row(y.view(-1, kp.n2), kp.rows, False)
    assert [(k.launches, k.plain_calls) for k in hf.KERNELS] == [(0, 1), (0, 1), (0, 0),
                                                                 (0, 0)]
    assert "fourstep" not in _build._libs  # nothing was built for CPU tensors
    meta = kp.to("meta")
    with pytest.raises(tg.NTTDeviceError):
        hf.fourstep_u64_col(torch.empty((2, kp.n), dtype=torch.int64, device="meta"), meta,
                            False)
    for bad in (x.to(torch.int32), x.reshape(-1, 2).t(), x[:, :-1]):
        with pytest.raises(tg.NTTDispatchError):
            hf.fourstep_u64_col(bad, kp, False)
    with pytest.raises(tg.NTTDispatchError):  # a u64 plan on the u32 kernel
        hf.fourstep_u32_col(x, kp, True)


def test_plan_defaults_to_the_card():
    p = tg.NTTParameters4Step(12)
    if torch.cuda.is_available():
        assert tg.FourStepPlan.from_params(p).device.type == "cuda"
    else:
        with pytest.raises(tg.NTTDeviceError):
            tg.FourStepPlan.from_params(p)
    plan = tg.FourStepPlan.from_params(p, device="cpu")
    assert plan.to("meta").n1_fwd.device == torch.device("meta")
    assert plan.to("cpu") is plan
