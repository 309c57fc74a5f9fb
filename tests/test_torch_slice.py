"""The port's main-path slice against gpuntt_tpu's, end to end (CPU, exact).

`ntt` / `intt` / `polymul` and `PolynomialMultiplier` of both packages on
the same numpy inputs, with the port's plans carried over from the JAX
package's own tables by MergePlan.from_arrays.  At logn 12 the port
routes through the three kernel wrappers (their plain versions here);
at logn 3 both packages run their butterfly engines.  Signed input and
output, PerCoefficient, 1-D and 3-D batches, and NTTConfig's ignored
fields are covered on both routes.
"""

import functools

import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.models.polymul import PolynomialMultiplier as JModel
from gpuntt_tpu.ops.limb import u64_to_numpy
from gpuntt_tpu.ops.merge_ntt import MergePlan as JPlan
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes

torch.set_num_threads(2)

PER_COEF = tg.NTTLayout.PerCoefficient


def carry(jplan):
    tab = u64_to_numpy if jplan.is64 else np.asarray
    p = jplan.params
    return tg.MergePlan.from_arrays(p.modulus.value, p.logn, p.poly_reduction,
                                    p.root_of_unity, p.inverse_root_of_unity, p.n_inv,
                                    tab(jplan.fwd_table), tab(jplan.inv_table),
                                    device="cpu", dtype=p.dtype)


def centered(x, q, dtype):
    """Canonical residues -> the signed values the signed entries use."""
    s = np.where(x > q // 2, x.astype(np.int64) - q, x.astype(np.int64))
    return s.astype(dtype)


@pytest.fixture(scope="module")
def kernel_cell():
    jp = jg.NTTParameters(12, jg.ReductionPolynomial.X_N_plus, np.uint64)
    jplan = JPlan.from_params(jp)
    rng = np.random.default_rng(12)
    x = rng.integers(0, jp.modulus.value, size=(3, jp.n), dtype=np.uint64)
    y = rng.integers(0, jp.modulus.value, size=(3, jp.n), dtype=np.uint64)
    want = dict(ntt=jg.ntt(x, jplan), intt=jg.intt(x, jplan),
                polymul=jg.polymul(x, y, jplan))
    return jp, carry(jplan), x, y, want


def test_converter_carries_the_jax_tables(kernel_cell):
    jp, plan, *_ = kernel_cell
    own = tg.MergePlan.from_params(tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus),
                                   device="cpu")
    for name in ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup"):
        assert torch.equal(getattr(plan, name), getattr(own, name)), name
    assert (plan.q, plan.bit, plan.mu, plan.n_inv, plan.n_inv_shoup, plan.xnp) == \
        (own.q, own.bit, own.mu, own.n_inv, own.n_inv_shoup, own.xnp)
    assert plan.genuine_root and hm.covers(plan)


def _counted(fn):
    hm.reset_counts()
    out = fn()
    return out, tuple(k.plain_calls for k in hm.KERNELS)


def test_kernel_route_matches_jax(kernel_cell):
    _, plan, x, y, want = kernel_cell
    got, calls = _counted(lambda: tg.ntt(x, plan))
    np.testing.assert_array_equal(got, want["ntt"])
    assert calls == (1, 0, 0)
    got, calls = _counted(lambda: tg.intt(x, plan))
    np.testing.assert_array_equal(got, want["intt"])
    assert calls == (0, 1, 0)
    got, calls = _counted(lambda: tg.polymul(x, y, plan))
    np.testing.assert_array_equal(got, want["polymul"])
    assert calls == (2, 0, 1)


def test_kernel_route_shapes_layouts_and_signs(kernel_cell):
    jp, plan, x, _, want = kernel_cell
    q = jp.modulus.value
    got, calls = _counted(lambda: tg.ntt(x[1], plan))
    np.testing.assert_array_equal(got, want["ntt"][1])
    assert calls == (1, 0, 0)  # 1-D keeps the kernel route
    got, calls = _counted(lambda: tg.intt(x.reshape(3, 1, -1), plan))
    np.testing.assert_array_equal(got, want["intt"].reshape(3, 1, -1))
    assert calls == (0, 1, 0)  # so does 3-D
    np.testing.assert_array_equal(tg.ntt(x.T.copy(), plan, layout=PER_COEF),
                                  want["ntt"].T)
    cfg = tg.NTTConfig(12, ntt_layout=PER_COEF, zero_padding=True, mod_inverse=12345)
    np.testing.assert_array_equal(tg.intt(x.T.copy(), plan, cfg), want["intt"].T)
    got = tg.ntt(centered(x, q, np.int64), plan)
    np.testing.assert_array_equal(got, want["ntt"])
    got = tg.intt(want["ntt"], plan, signed_output=True)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, centered(x, q, np.int64))


def test_polynomial_multiplier_module(kernel_cell):
    jp, _, x, y, want = kernel_cell
    model = tg.PolynomialMultiplier(tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus),
                                    device="cpu")
    assert isinstance(model, torch.nn.Module)
    assert {n for n, _ in model.named_buffers()} == \
        {"fwd_table", "fwd_shoup", "inv_table", "inv_shoup"}
    np.testing.assert_array_equal(model(x, y), want["polymul"])
    out = model.forward(to_lanes(x, True), to_lanes(y, True))
    np.testing.assert_array_equal(from_lanes(out, True), want["polymul"])
    moved = model.to("meta")
    assert moved.plan.device == torch.device("meta")


ENGINE_CASES = {
    "ntt": lambda m, p, c: m.ntt(c["x"], p),
    "ntt_signed_input": lambda m, p, c: m.ntt(c["xs"], p),
    "intt_signed_output": lambda m, p, c: m.intt(c["x"], p, signed_output=True),
    "ntt_per_coefficient": lambda m, p, c: m.ntt(c["x"].T.copy(), p,
                                                 layout=m.NTTLayout.PerCoefficient),
    "intt_3d": lambda m, p, c: m.intt(c["x"].reshape(2, 2, -1), p),
    "ntt_1d": lambda m, p, c: m.ntt(c["x"][0], p),
    "polymul": lambda m, p, c: m.polymul(c["x"], c["y"], p),
}


@functools.cache
def engine_cell(dtype):
    jp = jg.NTTParameters(3, jg.ReductionPolynomial.X_N_minus, dtype)
    jplan = JPlan.from_params(jp)
    q = jp.modulus.value
    rng = np.random.default_rng(6)
    x = rng.integers(0, q, size=(4, jp.n), dtype=np.uint64).astype(dtype)
    y = rng.integers(0, q, size=(4, jp.n), dtype=np.uint64).astype(dtype)
    sdt = np.int64 if dtype == np.uint64 else np.int32
    return dict(jp=jp, jplan=jplan, plan=carry(jplan), x=x, y=y, sdt=sdt,
                xs=centered(x, q, sdt))


# u64 runs the cases whose u64 semantics the kernel-route tests above do
# not already hold against JAX (each JAX compile costs about a second)
@pytest.mark.parametrize("dtype,case", [(np.uint32, c) for c in sorted(ENGINE_CASES)] + [
    (np.uint64, c) for c in ("ntt_signed_input", "intt_signed_output", "polymul")])
def test_engine_route_matches_jax(dtype, case):
    c = engine_cell(dtype)
    hm.reset_counts()
    fn = ENGINE_CASES[case]
    got, want = fn(tg, c["plan"], c), fn(jg, c["jplan"], c)
    out_dtype = c["sdt"] if case == "intt_signed_output" else c["jp"].dtype
    assert got.dtype == want.dtype == out_dtype
    np.testing.assert_array_equal(got, want)
    assert sum(k.plain_calls for k in hm.KERNELS) == 0  # engine route only


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_polynomial_multiplier_engine_route(dtype):
    c = engine_cell(dtype)
    model = tg.PolynomialMultiplier(tg.NTTParameters(3, tg.ReductionPolynomial.X_N_minus,
                                                     c["jp"].dtype), device="cpu")
    np.testing.assert_array_equal(model(c["x"], c["y"]), JModel(c["jp"])(c["x"], c["y"]))
