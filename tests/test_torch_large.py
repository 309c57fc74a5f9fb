"""The port's u64 big-ring path against gpuntt_tpu's (CPU, exact equality).

- K7's plain version against the JAX column kernel `_col_call` (interpret
  mode) at the reduced splits of tests/test_mxu_large.py, forward (the
  JAX output taken mod q: its forward is lazy, below 3q) and inverse,
  both reduction polynomials; K8's plain version against
  `_row_matmul_call` on the B <= 512 branch; the recursive composition
  against `pallas_mxu_large_u64`.
- The public entries ntt_lanes / intt_lanes / polymul_lanes at logn 18
  and 20 (default splits, plain versions on the CPU) against the JAX
  engine and the native oracle.
- LargePlan.from_jax_arrays against the port's own from_spec, table for
  table; the route table at logn 17-28; 1-D and PerCoefficient input; a
  logn-28 plan with no N-entry table; the big-ring entries' refusals.

Inputs come from numpy seeds; nothing above logn 20 is transformed here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import pallas_mxu_large as jml
from gpuntt_tpu.ops.merge_ntt import MergePlan as JPlan
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import merge_intt_lanes as jintt
from gpuntt_tpu.ops.merge_ntt import merge_ntt_lanes as jntt
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import barrett as bo
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus
POLYS = [MINUS, PLUS]


def data(p, batch, seed):
    return np.random.default_rng(seed).integers(0, p.modulus.value, size=(batch, p.n),
                                                 dtype=np.uint64)


def u64(pair) -> np.ndarray:
    """A JAX (hi, lo) pair of uint32 arrays as one uint64 array."""
    hi, lo = (np.asarray(v, dtype=np.uint64) for v in pair[:2])
    return (hi << np.uint64(32)) | lo


def port_params(jp):
    """The port's NTTParameters of the JAX package's `jp`."""
    return tg.NTTParameters(jp.logn, tg.ReductionPolynomial(jp.poly_reduction.value))


def port_plan(jp, **kw):
    return hml.LargePlan.from_params(port_params(jp), device="cpu", **kw)


# ----------------------------------------------------- kernels vs Pallas


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn,a_col", [(13, 4), (14, 8)])
def test_k7_plain_matches_pallas_col_call(logn, a_col, poly):
    jp = jg.NTTParameters(logn, poly, np.uint64)
    mp = jml.MXULargePlan.from_params(jp, a_col=a_col)
    lp = port_plan(jp, a_col=a_col)
    q = jp.modulus.value
    x = data(jp, 2, logn)
    for inverse, plain in ((False, hml.colfwd_plain), (True, hml.colinv_plain)):
        want = jfrom(jml._col_call(jto(x, True), mp, inverse=inverse, interpret=True),
                     True).reshape(2, -1) % np.uint64(q)
        np.testing.assert_array_equal(from_lanes(plain(to_lanes(x, True), lp), True), want)


@pytest.mark.parametrize("poly", POLYS)
def test_k8_plain_matches_pallas_row_matmul(poly):
    jp = jg.NTTParameters(13, poly, np.uint64)
    mp = jml.MXULargePlan.from_params(jp, a_col=32)  # B = 256
    lp = port_plan(jp, a_col=32)
    assert mp.row_fwd is not None and lp.row_kernel == "K8"
    x = data(jp, 2, 5)
    for inverse in (False, True):
        jx = jto(x.reshape(2, 32, 256), True)
        want = jfrom(jml._row_matmul_call(jx, mp, inverse=inverse, interpret=True), True)
        got = hml.rowmat_plain(to_lanes(x.reshape(64, 256), True), lp.rows, inverse)
        np.testing.assert_array_equal(from_lanes(got, True), want.reshape(64, 256))


def test_recursive_composition_matches_pallas():
    """Rows beyond max_row_logn recurse into a nested plan (the logn 27-28
    shape at the reduced split of test_mxu_large.py; X^N + 1, whose
    nested rows are X^B - 1 as for either polynomial)."""
    jp = jg.NTTParameters(14, PLUS, np.uint64)
    q = jp.modulus.value
    spec = (q, 14, jp.root_of_unity, jp.inverse_root_of_unity, True, pow(jp.n, q - 2, q))
    mp = jml.MXULargePlan.from_spec(*spec, a_col=8, max_row_logn=9,
                                    row_kwargs=dict(a_col=8))
    lp = hml.LargePlan.from_spec(*spec, a_col=8, max_row_logn=9,
                                 row_kwargs=dict(a_col=8), device="cpu")
    assert lp.row_kernel == "nested" and lp.nested.row_kernel == "K8"
    x = data(jp, 2, 3)
    hml.reset_counts()
    for inverse in (False, True):
        want = jfrom(jml.pallas_mxu_large_u64(jto(x, True), mp, inverse=inverse,
                                              interpret=True), True)
        got = hml.merge_u64_large(to_lanes(x, True), lp, inverse=inverse)
        np.testing.assert_array_equal(from_lanes(got, True), want)
    assert [k.plain_calls for k in hml.KERNELS] == [2, 2, 2]


# ------------------------------------------------- the public entries


@pytest.mark.parametrize("logn,poly", [(18, PLUS), (20, MINUS)])
def test_entries_match_jax_engine_and_native(logn, poly):
    """ntt and intt against the native oracle, and at logn 18 against the
    JAX engine too (one jit for both; at 2^20 its compile alone takes
    ten seconds, and the oracle is the JAX package's golden model);
    polymul against the oracle."""
    jp = jg.NTTParameters(logn, poly, np.uint64)
    plan = tg.MergePlan.from_params(port_params(jp), device="cpu")
    assert plan.fwd_table is None
    x, y = data(jp, 1, logn), data(jp, 1, logn + 1)
    gen = jg.NTTCPU(jp)
    hm.reset_counts()
    hml.reset_counts()
    fx, ix = tg.ntt(x, plan), tg.intt(x, plan)
    np.testing.assert_array_equal(fx, gen.ntt(x))
    np.testing.assert_array_equal(ix, gen.intt(x))
    if logn == 18:
        jplan = JPlan.from_params(jp)
        jf, ji = jax.jit(lambda v: (jntt(v, jplan), jintt(v, jplan)))(jto(x, True))
        np.testing.assert_array_equal(fx, jfrom(jf, True))
        np.testing.assert_array_equal(ix, jfrom(ji, True))
    np.testing.assert_array_equal(tg.polymul(x, y, plan),
                                  gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))
    # K7 forward for ntt and the two polymul forwards, inverse for intt and
    # polymul; the rows on K1 / K2 / K3 (the fused product)
    assert [k.plain_calls for k in hml.KERNELS] == [3, 2, 0]
    assert [k.plain_calls for k in hm.KERNELS] == [3, 1, 1]


def test_polymul_unfused_where_the_rows_do_not_fuse():
    """Rows of 2^17 (logn 26, here at a reduced split of 2^19 = 4 x 2^17
    is too big for the CPU; 2^13 x 4 carries the same rule): the product
    runs between the transforms, as in the JAX route, and equals the
    fused one."""
    p = tg.NTTParameters(13, tg.ReductionPolynomial.X_N_plus)
    lp = hml.LargePlan.from_params(p, a_col=4, device="cpu")
    assert lp.fuses_product
    x, y = (to_lanes(data(p, 2, s), True) for s in (1, 2))
    fx, fy = hml.merge_u64_large(x, lp), hml.merge_u64_large(y, lp)
    prod = bo.barrett_mul64(fx, fy, p.modulus.value, p.modulus.bit, p.modulus.mu)
    assert torch.equal(hml.merge_u64_large_polymul_inv(fx, fy, lp),
                       hml.merge_u64_large(prod, lp, inverse=True))
    big = hml.LargePlan.from_params(tg.NTTParameters(26), device="cpu")
    assert big.row_kernel == "K1" and not big.fuses_product
    with pytest.raises(ValueError):
        hml.merge_u64_large_polymul_inv(fx, fy, dataclasses.replace(lp, B=1 << 17))


def test_polynomial_multiplier_at_a_big_ring():
    p = tg.NTTParameters(18, tg.ReductionPolynomial.X_N_plus)
    model = tg.PolynomialMultiplier(p, device="cpu")
    assert {n for n, _ in model.named_buffers()} == {"anchor"}
    x, y = data(p, 1, 7), data(p, 1, 8)
    gen = tg.NTTCPU(p)
    np.testing.assert_array_equal(model(x, y), gen.intt(gen.mult(gen.ntt(x), gen.ntt(y))))
    assert model.to("meta").plan.device == torch.device("meta")


# --------------------------------------------------------- plans, routes


def _same(a, b, where="plan"):
    assert type(a) is type(b), where
    for f in dataclasses.fields(a):
        if f.name.startswith("_"):
            continue
        u, v = getattr(a, f.name), getattr(b, f.name)
        at = f"{where}.{f.name}"
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v), at
        elif isinstance(u, (hml.LargePlan, tg.MergePlan)):
            _same(u, v, at)
        else:
            assert u == v, at


@pytest.mark.parametrize("logn,kw", [
    (18, {}),                    # A = 128, K1 rows of 2^11
    (20, {}),
    (17, dict(a_col=512)),       # JAX's inverse W at tile_inv 128 < tile 256: refactored
    (14, dict(a_col=8, max_row_logn=9, row_kwargs=dict(a_col=8))),  # nested
])
def test_from_jax_arrays_equals_from_spec(logn, kw):
    jp = jg.NTTParameters(logn, PLUS, np.uint64)
    q = jp.modulus.value
    spec = (q, logn, jp.root_of_unity, jp.inverse_root_of_unity, True, pow(jp.n, q - 2, q))
    if logn >= 18:
        mp, own = jml.MXULargePlan.from_params(jp), port_plan(jp)
    else:
        mp = jml.MXULargePlan.from_spec(*spec, **kw)
        own = hml.LargePlan.from_spec(*spec, device="cpu", **kw)

    def carry(m):
        nested = carry(m.row_plan) if isinstance(m.row_plan, jml.MXULargePlan) else None
        return hml.LargePlan.from_jax_arrays(m.q, m.logn, m.A, m.B, m.tile, u64(m.wt_fwd),
                                             u64(m.ws_fwd), u64(m.wt_inv), u64(m.ws_inv),
                                             nested=nested, device="cpu")

    _same(carry(mp), own)


def test_route_table_for_big_rings():
    def route(logn, dtype=np.uint64, factors=None):
        p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, dtype, factors=factors)
        plan = tg.MergePlan.from_params(p, device="cpu")
        return td._kernel_path(plan, (1, p.n), tg.NTTLayout.PerPolynomial), plan

    assert route(17)[0] == "hopper-merge"
    for logn in range(18, 29):
        path, plan = route(logn)
        assert path == "hopper-merge-large" and plan.fwd_table is None, logn
    assert route(20, np.uint32)[0] == "hopper-merge32"
    q63, = tg.find_ntt_primes(63, 18, 1)
    om, psi = tg.ntt_root_pair(q63, 18)
    path, plan = route(18, factors=tg.NTTFactors(tg.Modulus64(q63), om, psi))
    assert path == "engine" and plan.fwd_table is not None  # q >= 2^62 keeps its tables
    mod = tg.Modulus64(576460756061519873)
    path, plan = route(18, factors=tg.NTTFactors(mod, 5, 7))
    assert path == "engine" and plan.fwd_table is not None  # no root of unity


def test_one_dim_and_per_coefficient_inputs_take_the_route():
    p = tg.NTTParameters(18, tg.ReductionPolynomial.X_N_minus)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = data(p, 2, 9)
    want = tg.ntt(x, plan)
    hml.reset_counts()
    np.testing.assert_array_equal(tg.ntt(x[1], plan), want[1])
    np.testing.assert_array_equal(
        tg.ntt(x.T.copy(), plan, layout=tg.NTTLayout.PerCoefficient), want.T)
    assert hml.COLFWD.plain_calls == 2


def test_table_less_plan_rebuilds_tables_for_the_engine():
    """The engine on a big-ring plan builds its N-entry tables on first
    use (with_tables), equal to an eager plan's and to the route."""
    p = tg.NTTParameters(18, tg.ReductionPolynomial.X_N_plus)
    plan = tg.MergePlan.from_params(p, device="cpu")
    eager = tg.MergePlan.from_params(p, device="cpu", tables=True)
    full = plan.with_tables()
    assert plan.fwd_table is None and full is plan.with_tables()
    for name in ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup"):
        assert torch.equal(getattr(full, name), getattr(eager, name)), name
    x = to_lanes(data(p, 1, 4), True)
    from gpuntt_tpu_torch.ops.merge_ntt import merge_ntt_lanes

    assert torch.equal(merge_ntt_lanes(x, plan), tg.ntt_lanes(x, plan))
    assert tg.MergePlan.from_params(p, device="cpu", tables=False).fwd_table is None


def test_logn28_plan_holds_no_ring_sized_table():
    p = tg.NTTParameters(28, tg.ReductionPolynomial.X_N_plus)
    plan = tg.MergePlan.from_params(p, device="cpu")
    assert plan.fwd_table is None and plan.device == torch.device("cpu")
    lp = hml.large_plan(plan)
    assert (lp.A, lp.B, lp.nested.A, lp.nested.B) == (512, 1 << 19, 128, 1 << 12)

    def tensors(v):
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (hml.LargePlan, tg.MergePlan)):
            for f in dataclasses.fields(v):
                if not f.name.startswith("_"):
                    yield from tensors(getattr(v, f.name))

    sizes = [t.numel() for t in tensors(lp)]
    assert max(sizes) <= 1 << 20  # the 2048 x 512 scale tables; the ring is 2^28
    assert sum(sizes) * 8 == lp.device_bytes() < 48 << 20


def test_big_ring_entries_refuse_off_the_card():
    """staged_* return None where the JAX entries do; here every tensor
    is on the CPU, which stands for the JAX entries' non-TPU backend."""
    p = tg.NTTParameters(18, tg.ReductionPolynomial.X_N_plus)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = to_lanes(data(p, 1, 1), True)
    assert td.staged_ntt_lanes(x, plan) is None
    assert td.staged_polymul_lanes(x, x, plan) is None
    meta = plan.to("meta")
    xm = torch.empty((1, p.n), dtype=torch.int64, device="meta")
    assert td.staged_ntt_lanes(xm, meta) is None  # logn 18 < 24, and not a card
