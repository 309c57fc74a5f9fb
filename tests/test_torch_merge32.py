"""The port's u32 merge path against gpuntt_tpu's (CPU, exact equality).

- The plain versions of the u32 kernels (hopper_merge32.py) against the
  JAX engine's merge_ntt_lanes / merge_intt_lanes at logn 8-20, and
  against the three Pallas kernels they replace, run in interpret mode
  at the small cells the JAX suite uses: pallas_merge2_u32 (K4),
  pallas_mxu_u32 (K5) and pallas_mxu32_large (K6).
- A JAX u32 MergePlan carried across with MergePlan.from_arrays at
  logn 12 and 18, then ntt / intt / polymul / signed and PerCoefficient
  entries and PolynomialMultiplier of both packages on the same inputs.
- The route table: which u32 shapes, moduli and layouts take
  "hopper-merge32", and which take the engine.
- The wrappers' CPU-only rule and their refusals.

Integer arithmetic throughout, so every comparison is exact (tolerance 0).
Nothing here runs above logn 20.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.models.polymul import PolynomialMultiplier as JModel
from gpuntt_tpu.ops.merge_ntt import MergePlan as JPlan
from gpuntt_tpu.ops.merge_ntt import merge_intt_lanes as jintt
from gpuntt_tpu.ops.merge_ntt import merge_ntt_lanes as jntt
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus
TPOLY = {MINUS: tg.ReductionPolynomial.X_N_minus, PLUS: tg.ReductionPolynomial.X_N_plus}
PER_COEF = tg.NTTLayout.PerCoefficient


def carry(jplan):
    """Port plan from the JAX package's own u32 plan tables."""
    p = jplan.params
    return tg.MergePlan.from_arrays(p.modulus.value, p.logn, p.poly_reduction,
                                    p.root_of_unity, p.inverse_root_of_unity, p.n_inv,
                                    np.asarray(jplan.fwd_table),
                                    np.asarray(jplan.inv_table), device="cpu",
                                    dtype=np.uint32)


def data(p, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.modulus.value, size=(batch, p.n),
                        dtype=np.uint64).astype(np.uint32)


def plan_of(logn, poly=PLUS, factors=None):
    p = tg.NTTParameters(logn, TPOLY.get(poly, poly), np.uint32, factors=factors)
    return p, tg.MergePlan.from_params(p, device="cpu")


def counts():
    return {k.name: (k.launches, k.plain_calls) for k in hm32.KERNELS
            if k.launches or k.plain_calls}


# ---------------------------------------- plain versions against the JAX engine


@pytest.mark.parametrize("logn,poly,batch", [
    (8, MINUS, 2), (8, PLUS, 2), (12, MINUS, 2), (12, PLUS, 2), (16, MINUS, 2),
    (16, PLUS, 2), (17, PLUS, 1), (18, MINUS, 1), (20, PLUS, 1)])
def test_plain_versions_match_jax_engine(logn, poly, batch):
    jp = jg.NTTParameters(logn, poly, np.uint32)
    jplan = JPlan.from_params(jp)
    plan = carry(jplan)
    x = data(jp, batch, logn)
    tx = to_lanes(x, False)
    want_f = np.asarray(jax.jit(lambda v: jntt(v, jplan))(x))
    want_i = np.asarray(jax.jit(lambda v: jintt(v, jplan))(x))
    np.testing.assert_array_equal(from_lanes(hm32.merge_u32_fwd_plain(tx, plan), False),
                                  want_f)
    np.testing.assert_array_equal(from_lanes(hm32.merge_u32_inv_plain(tx, plan), False),
                                  want_i)


def test_plain_versions_reduce_any_input():
    """Like the kernels, both plain versions reduce any u32 word mod q."""
    _, plan = plan_of(12)
    x = np.random.default_rng(4).integers(0, 1 << 32, size=(2, plan.n), dtype=np.uint64)
    xr = x % np.uint64(plan.q)
    for fn in (hm32.merge_u32_fwd_plain, hm32.merge_u32_inv_plain):
        assert torch.equal(fn(to_lanes(x, False), plan), fn(to_lanes(xr, False), plan))


# ------------------------- plain versions against the Pallas kernels they replace


def _pallas_cell(logn, poly, make_plan, fn, batch):
    jp = jg.NTTParameters(logn, poly, np.uint32)
    plan = carry(JPlan.from_params(jp))
    kplan = make_plan(jp)
    x, y = data(jp, batch, logn), data(jp, batch, logn + 1)
    got_f = from_lanes(hm32.merge_u32_fwd_plain(to_lanes(x, False), plan), False)
    np.testing.assert_array_equal(got_f, np.asarray(fn(x, kplan, interpret=True)))
    got_i = from_lanes(hm32.merge_u32_inv_plain(to_lanes(y, False), plan), False)
    np.testing.assert_array_equal(got_i, np.asarray(fn(y, kplan, inverse=True,
                                                       interpret=True)))


@pytest.mark.parametrize("poly", [MINUS, PLUS])
def test_plain_versions_match_k4_interpret(poly):
    from gpuntt_tpu.ops.pallas_merge import KernelMergePlan
    from gpuntt_tpu.ops.pallas_merge2 import pallas_merge2_u32

    _pallas_cell(10, poly, KernelMergePlan.from_params, pallas_merge2_u32, 2)


# K5 and K6 in interpret mode take seconds per row: one row, one poly each
# (the engine comparisons above cover both polys)
def test_plain_versions_match_k5_interpret():
    from gpuntt_tpu.ops.pallas_mxu32 import MXU32Plan, pallas_mxu_u32

    _pallas_cell(9, MINUS, MXU32Plan.from_params, pallas_mxu_u32, 1)


def test_plain_versions_match_k6_interpret():
    from gpuntt_tpu.ops.pallas_mxu32 import MXU32LargePlan, pallas_mxu32_large

    _pallas_cell(13, PLUS, lambda jp: MXU32LargePlan.from_params(jp, a_col=4),
                 pallas_mxu32_large, 1)


# ------------------------------------------- the slice, with carried JAX plans


@pytest.fixture(scope="module", params=[(12, MINUS), (18, PLUS)],
                ids=["logn12", "logn18"])
def carried(request):
    logn, poly = request.param
    jp = jg.NTTParameters(logn, poly, np.uint32)
    jplan = JPlan.from_params(jp)
    x, y = data(jp, 2, 1), data(jp, 2, 2)
    return jp, jplan, carry(jplan), x, y


def test_converter_carries_the_jax_u32_tables(carried):
    jp, _, plan, *_ = carried
    _, own = plan_of(jp.logn, jp.poly_reduction)
    for name in ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup"):
        assert torch.equal(getattr(plan, name), getattr(own, name)), name
    assert (plan.q, plan.bit, plan.mu, plan.n_inv, plan.n_inv_shoup, plan.xnp) == \
        (own.q, own.bit, own.mu, own.n_inv, own.n_inv_shoup, own.xnp)
    assert plan.genuine_root and hm32.covers(plan)


def test_carried_plan_runs_the_kernel_route(carried):
    jp, jplan, plan, x, y = carried
    k = hm32.tpu_kernel(jp.logn)
    fwd, inv = hm32.FORWARD[k].name, hm32.INVERSE[k].name
    hm32.reset_counts()
    np.testing.assert_array_equal(tg.ntt(x, plan), jg.ntt(x, jplan))
    assert counts() == {fwd: (0, 1)}
    hm32.reset_counts()
    np.testing.assert_array_equal(tg.intt(x, plan), jg.intt(x, jplan))
    assert counts() == {inv: (0, 1)}
    hm32.reset_counts()
    np.testing.assert_array_equal(tg.polymul(x, y, plan), jg.polymul(x, y, jplan))
    assert counts() == {fwd: (0, 2), inv: (0, 1)}


@pytest.mark.parametrize("carried", [(12, MINUS)], indirect=True, ids=["logn12"])
def test_carried_plan_layouts_and_signs(carried):
    jp, jplan, plan, x, _ = carried
    xs = x.astype(np.int64)
    xs = np.where(xs > jp.modulus.value // 2, xs - jp.modulus.value, xs).astype(np.int32)
    hm32.reset_counts()
    np.testing.assert_array_equal(tg.ntt(xs, plan), jg.ntt(xs, jplan))
    np.testing.assert_array_equal(tg.intt(x, plan, signed_output=True),
                                  jg.intt(x, jplan, signed_output=True))
    np.testing.assert_array_equal(
        tg.ntt(x.T.copy(), plan, layout=PER_COEF),
        jg.ntt(x.T.copy(), jplan, layout=jg.NTTLayout.PerCoefficient))
    np.testing.assert_array_equal(tg.intt(x[0], plan), jg.intt(x[0], jplan))
    k = hm32.tpu_kernel(jp.logn)
    # every one of them reached the kernel wrappers
    assert counts() == {hm32.FORWARD[k].name: (0, 2), hm32.INVERSE[k].name: (0, 2)}


def test_polynomial_multiplier_u32_kernel_route():
    jp = jg.NTTParameters(10, PLUS, np.uint32)
    x, y = data(jp, 3, 5), data(jp, 3, 6)
    model = tg.PolynomialMultiplier(tg.NTTParameters(10, tg.ReductionPolynomial.X_N_plus,
                                                     np.uint32), device="cpu")
    hm32.reset_counts()
    np.testing.assert_array_equal(model(x, y), JModel(jp)(x, y))
    assert counts() == {"merge_u32_forward_k4": (0, 2), "merge_u32_inverse_k4": (0, 1)}


# ---------------------------------------------------------------- route table


def route(plan, shape=None, layout=tg.NTTLayout.PerPolynomial):
    return td._kernel_path(plan, shape or (4, plan.n), layout)


def test_route_by_ring_size():
    assert [route(plan_of(n)[1]) for n in (7, 8, 16, 17, 18, 20)] == \
        ["engine"] + ["hopper-merge32"] * 5
    _, plan = plan_of(20)
    assert hm32.covers(dataclasses.replace(plan, logn=25))
    assert not hm32.covers(dataclasses.replace(plan, logn=26))
    assert [hm32.tpu_kernel(n) for n in (8, 16, 17, 18, 25)] == \
        ["K4", "K4", "K5", "K6", "K6"]
    assert [hm32.split(n) for n in (8, 13, 14, 16, 17, 20, 22, 23, 25)] == \
        [0, 0, 1, 3, 4, 7, 9, 8, 10]


@pytest.mark.parametrize("bits,path", [(20, "hopper-merge32"), (30, "hopper-merge32"),
                                       (31, "engine")])
def test_route_by_modulus(bits, path):
    """A ~20-bit and the widest admitted (30-bit) q take the kernels; a
    31-bit q (2q overflows the word) takes the engine."""
    q = tg.find_ntt_primes(bits, 12, 1)[0]
    omega, psi = tg.ntt_root_pair(q, 12)
    p, plan = plan_of(12, factors=tg.NTTFactors(tg.Modulus32(q), omega, psi))
    assert route(plan) == path
    x = data(p, 2, bits)
    gen = jg.NTTCPU(jg.NTTParameters(12, PLUS, np.uint32, factors=jg.NTTFactors(
        jg.Modulus32(q), omega, psi)))
    np.testing.assert_array_equal(tg.ntt(x, plan), gen.ntt(x))
    np.testing.assert_array_equal(tg.intt(x, plan), gen.intt(x))


def test_route_by_layout_shape_and_factors():
    _, plan = plan_of(12)
    assert route(plan, shape=(2, 2, plan.n)) == "engine"
    assert route(plan, layout=PER_COEF) == "engine"
    assert route(plan, shape=(plan.n,)) == "engine"
    p, odd = plan_of(12, factors=tg.NTTFactors(tg.Modulus32(469762049), 5, 7))
    assert not odd.genuine_root and route(odd) == "engine"
    hm32.reset_counts()
    tg.ntt(data(p, 2, 0), odd)
    assert counts() == {}
    u64 = tg.MergePlan.from_params(tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus,
                                                    np.uint64), device="cpu")
    assert not hm32.covers(u64) and route(u64) == "hopper-merge"


# ------------------------------------------------------------ wrapper contract


def test_wrappers_take_plain_versions_on_cpu_only():
    p, plan = plan_of(17)
    x = to_lanes(data(p, 2, 8), False)
    hm32.reset_counts()
    assert torch.equal(hm32.merge_u32_inv(hm32.merge_u32_fwd(x, plan), plan), x)
    assert counts() == {"merge_u32_forward_k5": (0, 1), "merge_u32_inverse_k5": (0, 1)}
    assert "merge_u32" not in _build._libs  # nothing was built for CPU tensors

    meta = plan.to("meta")
    with pytest.raises(tg.NTTDeviceError):
        hm32.merge_u32_fwd(torch.empty((2, p.n), dtype=torch.int64, device="meta"), meta)
    for bad in (x.to(torch.int32), x.reshape(-1, 2).t(), x.reshape(1, 2, -1)):
        with pytest.raises(tg.NTTDispatchError):
            hm32.merge_u32_fwd(bad, plan)
    for other in (plan_of(7)[1], tg.MergePlan.from_params(
            tg.NTTParameters(17, tg.ReductionPolynomial.X_N_plus, np.uint64),
            device="cpu")):
        with pytest.raises(tg.NTTDispatchError):
            hm32.merge_u32_inv(x, other)
