"""The port's factored merge kernels, K15 (u64) and K17 (u32), against
gpuntt_tpu (CPU, exact equality: integer arithmetic, tolerance 0).

- KernelMergePlan: its tables against the JAX package's
  KernelMergePlan.from_params at logn 7, 8 and 12, both polynomials and
  word sizes, and a plan carried across with `from_arrays`.
- The plain versions against the Pallas kernels they replace, in
  interpret mode: K15 (pallas_merge2_u64) at logn 8 on the pool prime and
  at logn 9 on a q past 2^62, K17 (pallas_merge_u32) at logn 8 and 9,
  both directions, batch 2 (eight interpret calls; JAX's compiles of
  them take most of this file's time).
- The route: ntt_lanes / intt_lanes / polymul_lanes with
  use_pallas="vpu" on u64 run K15's plain version, against the JAX
  package's NTTCPU at logn 7, 12 and 16, its schoolbook multiplication
  at logn 7, both polynomials; 62-bit and past-62-bit q at logn 10 (past
  62 bits the polymul against the reference's Barrett product, see the
  test); the JAX package's polymul_lanes(use_pallas="vpu"), K15 in
  interpret mode, at the past-62-bit q; factors that are no root of
  unity against JAX's K15 in interpret mode; signed input and output and
  the PerCoefficient layout; the limits raise.
- kmerge_u32 against the JAX package's NTTCPU at logn 7, 13 and 17.
- csrc/kmerge.cu compiled by g++ through the host emulation of
  test_torch_merge.py against the plain version at every logn 7-17, both
  polynomials, u64 and u32: its one-block form and its column + row
  launches (one and two runs of column stages, every pass split), and
  both u64 value policies on either side of 2^62 (the lazy instance at
  the largest NTT primes below 2^62, the canonical one at a q past 2^62
  and at 63-bit primes), on any input word.
- The wrappers' contract: CPU tensors take the plain version (counted),
  other devices raise, the plan is cached and builds W per direction.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import dispatch as jd
from gpuntt_tpu.ops import pallas_merge64 as jpm64
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
from gpuntt_tpu.ops.pallas_merge import KernelMergePlan as JKernelMergePlan
from gpuntt_tpu.ops.pallas_merge import pallas_merge_u32
from gpuntt_tpu.ops.pallas_merge64 import pallas_merge2_u64
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import hopper_kmerge as hk
from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes
from gpuntt_tpu_torch.utils.kernel_bench import largest_ntt_prime

from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

MINUS, PLUS = tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus
POLYS = [MINUS, PLUS]
# (q, psi of order 2^13) from tests/test_wide_modulus.py: q = 2^62 - 1.1e9,
# and a q past 2^62
WIDE62 = (4611684918915809281, 4166544109213919754)
OVER62 = (4611686018427494401, 795177494079348431)


def params(pkg, logn, poly, dtype=np.uint64, wide=None):
    """NTTParameters of either package, on the pool prime or on `wide`
    (q, psi of order 2^13) with psi cut to order 2^(logn + 1)."""
    poly = pkg.ReductionPolynomial(poly.value)
    if wide is None:
        return pkg.NTTParameters(logn, poly, dtype)
    q, psi = wide
    psi = pow(psi, 1 << (12 - logn), q)
    return pkg.NTTParameters(logn, poly, dtype, factors=pkg.NTTFactors(
        pkg.Modulus64(q), psi * psi % q, psi))


def jax_params(logn, poly, dtype=np.uint64, wide=None):
    """params(jg, ...), one object per cell: the JAX package caches its
    kernel plan on it (MergePlan.kernel_plan), so `jax_k15` compiles
    each cell's kernels once for every test that runs them."""
    return _jax_params(logn, poly, dtype, wide)


_jax_params = functools.cache(functools.partial(params, jg))


_K15 = {}


def jax_k15(x, plan, inverse=False):
    """pallas_merge2_u64 in interpret mode, compiled once per plan and
    shape: both directions at the first call, their XLA compiles side by
    side (they release the GIL; tracing does not, so it runs first)."""
    key = (id(plan), x.hi.shape)
    if key not in _K15:
        lowered = [jax.jit(functools.partial(pallas_merge2_u64, plan=plan, inverse=inv,
                                             interpret=True)).lower(x) for inv in (False, True)]
        with ThreadPoolExecutor(2) as pool:
            _K15[key] = plan, list(pool.map(lambda lo: lo.compile(), lowered))
    return _K15[key][1][inverse](x)


def data(p, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64).astype(p.dtype)


def u64(t):
    return from_lanes(t, True)


# ------------------------------------------------------------------ plan


def _jax_fields(jkp):
    return dict(col_fwd=jkp.col_fwd, w_fwd=jkp.w_fwd, row_fwd=jkp.row_fwd,
                col_inv=jkp.col_inv, w_inv=jkp.w_inv, row_inv=jkp.row_inv)


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", [7, 8, 12])
def test_plan_tables_match_jax(logn, poly, dtype):
    jkp = JKernelMergePlan.from_params(params(jg, logn, poly, dtype))
    kp = hk.KernelMergePlan.from_params(params(tg, logn, poly, dtype), device="cpu")
    assert (kp.logn, kp.q, kp.is64, kp.xnp, kp.A, kp.n_inv) == \
        (jkp.logn, jkp.q, jkp.is64, jkp.xnp, jkp.A, jkp.n_inv)
    own = dict(col_fwd=kp.col_fwd, w_fwd=kp.w(False)[0], row_fwd=kp.row_fwd,
               col_inv=kp.col_inv, w_inv=kp.w(True)[0], row_inv=kp.row_inv)
    for name, want in _jax_fields(jkp).items():
        np.testing.assert_array_equal(u64(own[name]), np.asarray(want, dtype=np.uint64),
                                      err_msg=name)
    carried = hk.KernelMergePlan.from_arrays(jkp.logn, jkp.q, jkp.is64, jkp.xnp,
                                             n_inv=jkp.n_inv, device="cpu", **_jax_fields(jkp))
    for a, b in zip(carried.tables(False) + carried.tables(True),
                    kp.tables(False) + kp.tables(True)):
        assert torch.equal(a, b)
    assert carried.n_inv_s == kp.n_inv_s


# ------------------------------------------------ plain versions vs Pallas


@pytest.mark.parametrize("dtype,logn,poly,wide", [
    (np.uint64, 8, MINUS, None),
    (np.uint64, 9, PLUS, OVER62),
    (np.uint32, 8, PLUS, None),
    (np.uint32, 9, MINUS, None),
])
def test_plain_matches_pallas_interpret(dtype, logn, poly, wide):
    """K15's and K17's plain versions against the Pallas kernels
    (interpret mode), both directions, batch 2 of canonical residues."""
    jp = jax_params(logn, poly, dtype, wide)
    jkp = jg.MergePlan.from_params(jp).kernel_plan()
    kp = hk.KernelMergePlan.from_params(params(tg, logn, poly, dtype, wide), device="cpu")
    x = data(jp, 2, logn)
    is64 = dtype == np.uint64
    for inverse in (False, True):
        if is64:
            want = jfrom(jax_k15(jto(x, True), jkp, inverse), True)
        else:
            want = np.asarray(pallas_merge_u32(jto(x, False), jkp, inverse=inverse,
                                               interpret=True))
        got = from_lanes(hk.kmerge_plain(to_lanes(x, is64), kp, inverse), is64)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the "vpu" route


def _counts():
    return {k.name: k.plain_calls for k in (*hk64.KERNELS, *hm.KERNELS) if k.plain_calls}


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", [7, 12, 16])
def test_vpu_entries_match_golden(logn, poly):
    p, jp = params(tg, logn, poly), params(jg, logn, poly)
    plan = tg.MergePlan.from_params(p, device="cpu")
    gen = jg.NTTCPU(jp)
    a, b = data(p, 2, logn), data(p, 2, logn + 1)
    tracing.reset()
    fa = tg.ntt_lanes(to_lanes(a, True), plan, use_pallas="vpu")
    np.testing.assert_array_equal(u64(fa), gen.ntt(a))
    back = tg.intt_lanes(fa, plan, use_pallas="vpu")
    np.testing.assert_array_equal(u64(back), a)
    np.testing.assert_array_equal(u64(tg.intt_lanes(to_lanes(a, True), plan, use_pallas="vpu")),
                                  gen.intt(a))
    prod = u64(tg.polymul_lanes(to_lanes(a, True), to_lanes(b, True), plan, use_pallas="vpu"))
    if logn == 7:
        want = np.stack([jg.schoolbook_poly_multiplication(u, v, jp.modulus, jp.poly_reduction)
                         for u, v in zip(a, b)])
    else:
        want = gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
    np.testing.assert_array_equal(prod, want)
    # K15's plain version only: ntt, intt twice, polymul's two forwards and
    # its unfused inverse
    assert _counts() == {"kmerge_u64_forward": 3, "kmerge_u64_inverse": 3}


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("wide", [WIDE62, OVER62], ids=["wide62", "over62"])
def test_vpu_wide_moduli(wide, poly):
    """q = 2^62 - 1.1e9 and a q past 2^62 at logn 10: K15 needs no
    second value policy (csrc/kmerge.cu).  Past 2^62 the reference's
    Barrett product, which polymul_lanes runs between the transforms on
    this route (the JAX package's pointwise_mult_lanes), is out of its
    documented domain: it leaves words up to ~3q that are not the product
    mod q, and K15, the JAX package's as the port's, transforms them mod q.
    So the polymul is held to NTTCPU's inverse of that product mod q."""
    p, jp = params(tg, 10, poly, wide=wide), params(jg, 10, poly, wide=wide)
    plan = tg.MergePlan.from_params(p, device="cpu")
    gen = jg.NTTCPU(jp)
    a, b = data(p, 2, 10), data(p, 2, 11)
    tracing.reset()
    fa = tg.ntt_lanes(to_lanes(a, True), plan, use_pallas="vpu")
    np.testing.assert_array_equal(u64(fa), gen.ntt(a))
    np.testing.assert_array_equal(u64(tg.intt_lanes(fa, plan, use_pallas="vpu")), a)
    prod = gen.mult(gen.ntt(a), gen.ntt(b))
    if wide is OVER62:
        jplan = jg.MergePlan.from_params(jp)
        prod = jfrom(jax.jit(lambda u, v: jd.pointwise_mult_lanes(u, v, jplan))(
            jto(gen.ntt(a), True), jto(gen.ntt(b), True)), True) % np.uint64(p.modulus.value)
    np.testing.assert_array_equal(
        u64(tg.polymul_lanes(to_lanes(a, True), to_lanes(b, True), plan, use_pallas="vpu")),
        gen.intt(prod))
    assert hk64.FORWARD.plain_calls == 3 and hk64.INVERSE.plain_calls == 2


def test_vpu_signed_and_layout():
    """signed_input, signed_output and PerCoefficient behave on the K15
    route as on the default one (K1/K2), logn 12, X^N + 1."""
    p = params(tg, 12, PLUS)
    plan = tg.MergePlan.from_params(p, device="cpu")
    q = p.modulus.value
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.integers(-(q // 2), q // 2, size=(3, p.n), dtype=np.int64))
    for kw in ({"signed_input": True}, {"layout": tg.NTTLayout.PerCoefficient}):
        x = s if kw.get("signed_input") else s.abs().t().contiguous()
        tracing.reset()
        got = tg.ntt_lanes(x, plan, use_pallas="vpu", **kw)
        assert hk64.FORWARD.plain_calls == 1
        assert torch.equal(got, tg.ntt_lanes(x, plan, **kw)), kw
    f = tg.ntt_lanes(s, plan, signed_input=True)
    for kw in ({"signed_output": True}, {"layout": tg.NTTLayout.PerCoefficient}):
        x = f if kw.get("signed_output") else f.t().contiguous()
        assert torch.equal(tg.intt_lanes(x, plan, use_pallas="vpu", **kw),
                           tg.intt_lanes(x, plan, **kw)), kw
    assert torch.equal(tg.intt_lanes(f, plan, use_pallas="vpu", signed_output=True), s)


def test_vpu_polymul_matches_jax_k15_over62(monkeypatch):
    """polymul_lanes(use_pallas="vpu") at the past-62-bit q against the
    JAX package's own, which runs K15 in interpret mode (its two
    forwards, the pointwise product, its inverse), logn 9, X^N + 1,
    batch 2, the cell of test_plain_matches_pallas_interpret whose
    kernels it shares: the Barrett product's words up to ~3q reach K15
    in both packages."""
    monkeypatch.setattr(jpm64, "pallas_merge2_u64", jax_k15)
    p, jp = params(tg, 9, PLUS, wide=OVER62), jax_params(9, PLUS, wide=OVER62)
    a, b = data(p, 2, 9), data(p, 2, 10)
    want = jfrom(jd.polymul_lanes(jto(a, True), jto(b, True), jg.MergePlan.from_params(jp),
                                  use_pallas="vpu"), True)
    tracing.reset()
    got = tg.polymul_lanes(to_lanes(a, True), to_lanes(b, True),
                           tg.MergePlan.from_params(p, device="cpu"), use_pallas="vpu")
    np.testing.assert_array_equal(u64(got), want)
    assert (hk64.FORWARD.plain_calls, hk64.INVERSE.plain_calls) == (2, 1)


def test_vpu_any_factors_match_jax_k15():
    """Factors that are no root of unity take K15's counterpart, as the
    JAX package's "vpu" route takes K15 for any factors: ntt_lanes against
    pallas_merge2_u64 in interpret mode on the JAX plan of the same
    factors, logn 8, X^N + 1; intt_lanes takes the same route."""
    def odd(pkg):
        return pkg.NTTParameters(8, pkg.ReductionPolynomial.X_N_plus, np.uint64,
                                 factors=pkg.NTTFactors(pkg.Modulus64(576460752303415297),
                                                        5, 7))
    p = odd(tg)
    x = data(p, 1, 5)
    want = jfrom(pallas_merge2_u64(jto(x, True), JKernelMergePlan.from_params(odd(jg)),
                                   interpret=True), True)
    plan = tg.MergePlan.from_params(p, device="cpu")
    tracing.reset()
    fx = tg.ntt_lanes(to_lanes(x, True), plan, use_pallas="vpu")
    np.testing.assert_array_equal(u64(fx), want)
    tg.intt_lanes(fx, plan, use_pallas="vpu")
    assert (hk64.FORWARD.plain_calls, hk64.INVERSE.plain_calls) == (1, 1)


def test_vpu_limits():
    """Below logn 7 (where JAX's KernelMergePlan asserts A >= 1), above
    24 (the W table's size) and on an evaluation-twisted plan (which the
    JAX package's MergePlan has no counterpart of) the route raises."""
    with pytest.raises(tg.NTTDispatchError, match="N >= 128"):
        hk.KernelMergePlan.from_params(params(tg, 6, PLUS), device="cpu")
    with pytest.raises(AssertionError):
        JKernelMergePlan.from_params(params(jg, 6, PLUS))
    p6 = tg.MergePlan.from_params(params(tg, 6, PLUS), device="cpu")
    with pytest.raises(tg.NTTDispatchError, match="logn 7-24"):
        tg.ntt_lanes(torch.zeros((1, 64), dtype=torch.int64), p6, use_pallas="vpu")
    p25 = tg.MergePlan.from_params(params(tg, 25, PLUS), device="cpu")
    x25 = torch.empty((1, 1 << 25), dtype=torch.int64, device="meta")
    for fn in (tg.ntt_lanes, tg.intt_lanes):
        with pytest.raises(tg.NTTDispatchError, match="W table"):
            fn(x25, p25, use_pallas="vpu")
    p = params(tg, 9, PLUS)
    q, omega = p.modulus.value, p.root_of_unity ** 2 % p.modulus.value
    twisted = tg.MergePlan.from_eval(q, 9, omega, pow(omega, -1, q), 3, pow(3, -1, q), p.n_inv,
                                     device="cpu")
    x = to_lanes(data(p, 1, 5), True)
    tracing.reset()
    for fn in (tg.ntt_lanes, tg.intt_lanes):
        with pytest.raises(tg.NTTDispatchError, match="twist"):
            fn(x, twisted, use_pallas="vpu")
    assert hk64.FORWARD.plain_calls == hk64.INVERSE.plain_calls == 0


# ---------------------------------------------------------------- K17


@pytest.mark.parametrize("logn,poly", [(7, PLUS), (13, MINUS), (17, PLUS)])
def test_kmerge_u32_matches_golden(logn, poly):
    p = params(tg, logn, poly, np.uint32)
    kp = hk.kernel_plan(tg.MergePlan.from_params(p, device="cpu"))
    gen = jg.NTTCPU(params(jg, logn, poly, np.uint32))
    x = data(p, 2, logn)
    tracing.reset()
    fx = hk.kmerge_u32(to_lanes(x, False), kp)
    np.testing.assert_array_equal(from_lanes(fx, False), gen.ntt(x))
    np.testing.assert_array_equal(from_lanes(hk.kmerge_u32(fx, kp, inverse=True), False), x)
    assert (hk.FORWARD.plain_calls, hk.INVERSE.plain_calls) == (1, 1)


# ------------------------------------------- the CUDA source, emulated


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulate(tmp_path_factory, "kmerge")


def _emulated_call(lib, x, kp, inverse):
    y = torch.empty_like(x)
    consts = [kp.q, (1 << kp.word) // kp.q] + ([kp.n_inv, kp.n_inv_s] if inverse else [])
    entry = getattr(lib, f"kmerge_u{kp.word}_{'inverse' if inverse else 'forward'}")
    rc = entry(0, x.data_ptr(), y.data_ptr(), x.shape[0], kp.logn,
               *(t.data_ptr() for t in kp.tables(inverse)), *consts, int(kp.xnp), None)
    assert rc == 0
    return y


def _emulated_matches_plain(lib, p, seed):
    kp = hk.KernelMergePlan.from_params(p, device="cpu")
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1 << 64, size=(2, p.n), dtype=np.uint64, endpoint=False).view(np.int64))
    if p.dtype == np.uint32:
        x = x & 0xFFFFFFFF
    for inverse in (False, True):
        assert torch.equal(_emulated_call(lib, x, kp, inverse),
                           hk.kmerge_plain(x, kp, inverse)), inverse


# one block per ring up to logn 14 (no column stage at 7, column passes
# of 1-3 stages up to 10, two passes up to 13, three at 14), then column
# launches (one run of 8 or 9 stages at 15-16, two of 5 at 17) and the row
# launch; u64 and u32 alike
@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("logn", range(7, 18))
def test_cuda_source_emulated_matches_plain(emulated, logn, poly, dtype):
    _emulated_matches_plain(emulated, params(tg, logn, poly, dtype), logn)


def _prime_params(q, logn, poly):
    om, psi = tg.ntt_root_pair(q, logn)
    return tg.NTTParameters(logn, poly, np.uint64,
                            factors=tg.NTTFactors(tg.Modulus64(q), om, psi))


# (modulus, logn): the lazy instance at its edge (WIDE62, the largest NTT
# prime below 2^62 of order 2^14; at logn 17 the largest of order 2^18),
# the canonical one past it (OVER62, and the largest 63-bit NTT primes),
# in the one-block form (12) and the column + row launches (17)
POLICY_CASES = {
    "wide62-12": lambda poly: params(tg, 12, poly, wide=WIDE62),
    "over62-12": lambda poly: params(tg, 12, poly, wide=OVER62),
    "q63-12": lambda poly: _prime_params(largest_ntt_prime(63, 12), 12, poly),
    "edge62-17": lambda poly: _prime_params(largest_ntt_prime(62, 17), 17, poly),
    "q63-17": lambda poly: _prime_params(largest_ntt_prime(63, 17), 17, poly),
}


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_cuda_source_emulated_value_policy(emulated, case, poly):
    """kmerge_u64_* pick their value policy from q: below 2^62 the lazy
    butterflies (values below 4q), from 2^62 the canonical ones, whose
    sums stay below 2q < 2^64.  Both sides of 2^62 match the plain
    version on any u64 word."""
    p = POLICY_CASES[case](poly)
    assert (p.modulus.value < 1 << 62) == case.startswith(("wide62", "edge62"))
    _emulated_matches_plain(emulated, p, p.logn + 1)


def test_cuda_source_emulated_refuses_bad_shapes(emulated):
    """logn outside 7-25, no rings, and a grid past an int: refused
    before any launch (cudaErrorInvalidValue)."""
    kp = hk.KernelMergePlan.from_params(params(tg, 8, PLUS), device="cpu")
    x = torch.zeros((1, kp.n), dtype=torch.int64)
    for logn, batch in ((6, 1), (26, 1), (8, 0), (16, 1 << 20)):
        rc = emulated.kmerge_u64_forward(0, x.data_ptr(), x.data_ptr(), batch, logn,
                                         *(t.data_ptr() for t in kp.tables(False)), kp.q,
                                         (1 << 64) // kp.q, 1, None)
        assert rc == 1, (logn, batch)


# ---------------------------------------------------------- the contract


def test_wrappers_take_plain_versions_on_cpu_only():
    p = params(tg, 9, PLUS)
    plan = tg.MergePlan.from_params(p, device="cpu")
    kp = hk.kernel_plan(plan)
    assert hk.kernel_plan(plan) is kp and kp._w == {}
    x = to_lanes(data(p, 2, 1), True)
    tracing.reset()
    hk64.kmerge_u64(x, kp)
    assert list(kp._w) == [False]  # W is built per direction, at first use
    assert [(k.launches, k.plain_calls) for k in (*hk64.KERNELS, *hk.KERNELS)] == \
        [(0, 1), (0, 0), (0, 0), (0, 0)]
    assert "kmerge" not in _build._libs  # nothing was built for CPU tensors
    # column prefix (2A) and row table (64) per direction with companions,
    # and one W (A x 128) with its companion
    assert kp.device_bytes() == 8 * (2 * 2 * (2 * kp.A + 64) + 2 * kp.n)
    meta = hk.KernelMergePlan.from_params(p, device="meta")
    with pytest.raises(tg.NTTDeviceError):
        hk64.kmerge_u64(torch.empty((2, kp.n), dtype=torch.int64, device="meta"), meta)
    for bad in (x.to(torch.int32), x.reshape(-1, 2).t(), x[:, :-1], x[:0]):
        with pytest.raises(tg.NTTDispatchError):
            hk64.kmerge_u64(bad, kp)
    with pytest.raises(tg.NTTDispatchError):  # a u64 plan on the u32 kernel
        hk.kmerge_u32(x, kp)


def test_chip_smoke_kmerge_phase_rehearses_on_the_cpu():
    """chip_smoke.py's kmerge phase at small cells on the host, the
    kernels' plain versions counted in place of their launches: the
    phase's own checks (routes, counts, the default routes, NTTCPU,
    schoolbook, the wide moduli, signed input and PerCoefficient) pass."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    launches, err = {}, {}
    cs.kmerge_phase(torch.device("cpu"), np.random.default_rng(0),
                    tracing.reset, launches, err, {}, {},
                    sizes=dict(main=(10, 4), k15=((9, 2), (10, 2)), k17=((9, 4), (10, 2)),
                               k17_top=(11, 1)))
    names = [k.name for k in (*hk64.KERNELS, *hk.KERNELS)]
    assert launches == dict(zip(names, (3, 2, 1, 1)))
    assert err == dict.fromkeys(names, 0)
