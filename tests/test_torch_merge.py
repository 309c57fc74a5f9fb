"""The port's merge engine and main-path kernels (CPU, exact equality).

- The torch butterfly engine against the JAX XLA engine at logn 2-11,
  u32 and u64, both polys, plus caller factors that are no root of
  unity; plans carried across with MergePlan.from_arrays.
- The plain versions of the three kernels against the Pallas kernels
  they replace (interpret mode, one logn-12 cell) and against the JAX
  engine's merge_ntt_lanes / merge_intt_lanes, and what polymul_lanes
  computes off the TPU, at logn 12-14 (polymul_lanes itself is called
  in test_torch_slice.py).
- The CUDA source itself, compiled by g++ through a host emulation of
  the few CUDA constructs it uses (one thread per block, blocks in
  order), against the plain versions at logn 12-17: this checks the
  kernels' index arithmetic and twiddle addressing without a card.
- Wrapper contract: CPU tensors take the plain version (counted), other
  devices launch or raise, bad operands raise, and the route table.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import dispatch as jd
from gpuntt_tpu.ops.limb import u64_to_numpy
from gpuntt_tpu.ops.merge_ntt import MergePlan as JPlan
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import merge_intt_lanes as jintt
from gpuntt_tpu.ops.merge_ntt import merge_ntt_lanes as jntt
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops.merge_ntt import (from_lanes, merge_intt_lanes,
                                            merge_ntt_lanes, to_lanes)

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "gpuntt_tpu_torch", "csrc")


def carry(jp, device="cpu"):
    """Port plan from the JAX package's own plan tables (the converter)."""
    jplan = JPlan.from_params(jp)
    tab = (u64_to_numpy if jplan.is64 else np.asarray)
    return tg.MergePlan.from_arrays(
        jp.modulus.value, jp.logn, jp.poly_reduction, jp.root_of_unity,
        jp.inverse_root_of_unity, jp.n_inv, tab(jplan.fwd_table),
        tab(jplan.inv_table), device=device, dtype=jp.dtype), jplan


def data(p, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, p.modulus.value, size=(batch, p.n),
                        dtype=np.uint64).astype(p.dtype)


def jax_run(fn, x, jplan):
    return jfrom(jax.jit(fn)(jto(x, jplan.is64)), jplan.is64).astype(x.dtype)


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("logn,dtype,poly", [
    (2, np.uint64, PLUS), (5, np.uint32, MINUS), (6, np.uint64, MINUS),
    (11, np.uint32, PLUS)])
def test_engine_matches_jax_engine(logn, dtype, poly):
    jp = jg.NTTParameters(logn, poly, dtype)
    plan, jplan = carry(jp)
    x = data(jp, 3, logn)
    fx = from_lanes(merge_ntt_lanes(to_lanes(x, plan.is64), plan), plan.is64)
    np.testing.assert_array_equal(fx, jax_run(lambda v: jntt(v, jplan), x, jplan))
    ix = from_lanes(merge_intt_lanes(to_lanes(x, plan.is64), plan), plan.is64)
    np.testing.assert_array_equal(ix, jax_run(lambda v: jintt(v, jplan), x, jplan))


@pytest.mark.parametrize("logn,dtype", [(4, np.uint64), (6, np.uint32)])
def test_engine_matches_jax_engine_on_non_root_factors(logn, dtype):
    """Caller factors that are no root of unity: the reference computes
    garbage-in/garbage-out through its butterflies, and so must both
    engines."""
    mod = jg.Modulus64(576460756061519873) if dtype == np.uint64 else jg.Modulus32(469762049)
    jp = jg.NTTParameters(logn, PLUS, dtype, factors=jg.NTTFactors(mod, 5, 7))
    plan, jplan = carry(jp)
    assert not plan.genuine_root
    x = data(jp, 2, 1)
    np.testing.assert_array_equal(tg.ntt(x, plan),
                                  jax_run(lambda v: jntt(v, jplan), x, jplan))
    np.testing.assert_array_equal(tg.intt(x, plan),
                                  jax_run(lambda v: jintt(v, jplan), x, jplan))


def test_non_root_factors_at_kernel_sizes_take_the_engine():
    mod = jg.Modulus64(576460756061519873)
    jp = jg.NTTParameters(12, MINUS, np.uint64, factors=jg.NTTFactors(mod, 5, 7))
    plan, _ = carry(jp)
    x = data(jp, 2, 1)
    assert td._kernel_path(plan, x.shape, tg.NTTLayout.PerPolynomial) == "engine"
    hm.reset_counts()
    got = tg.ntt(x, plan)
    assert sum(k.plain_calls for k in hm.KERNELS) == 0
    np.testing.assert_array_equal(got, jg.NTTCPU(jp).ntt(x))


# ------------------------------------------------ kernels' plain versions


def test_plain_versions_match_pallas_interpret():
    from gpuntt_tpu.ops.pallas_mxu import (MXUMergePlan, pallas_mxu_polymul_inv_u64,
                                           pallas_mxu_u64)

    jp = jg.NTTParameters(12, PLUS, np.uint64)
    plan, _ = carry(jp)
    mp = MXUMergePlan.from_params(jp)
    x, y = data(jp, 1, 2), data(jp, 1, 3)
    tx, ty = to_lanes(x, True), to_lanes(y, True)

    def pallas(*args, **kw):
        return jfrom(pallas_mxu_u64(*[jto(a, True) for a in args], mp,
                                    interpret=True, **kw), True)

    fx = from_lanes(hm.merge_u64_fwd_plain(tx, plan), True)
    np.testing.assert_array_equal(fx, pallas(x))
    np.testing.assert_array_equal(from_lanes(hm.merge_u64_inv_plain(ty, plan), True),
                                  pallas(y, inverse=True))
    fy = hm.merge_u64_fwd_plain(ty, plan)
    got = from_lanes(hm.merge_u64_polymul_inv_plain(to_lanes(fx, True), fy, plan), True)
    want = jfrom(pallas_mxu_polymul_inv_u64(jto(fx, True), jto(from_lanes(fy, True), True),
                                            mp, interpret=True), True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logn,poly", [(12, MINUS), (14, PLUS)])
def test_plain_versions_match_jax_engine(logn, poly):
    """Forward and inverse against merge_ntt_lanes / merge_intt_lanes;
    the fused polymul against what jd.polymul_lanes computes off the
    TPU: those two with jd.pointwise_mult_lanes between them."""
    jp = jg.NTTParameters(logn, poly, np.uint64)
    plan, jplan = carry(jp)
    a, b = data(jp, 2, logn), data(jp, 2, logn + 1)
    jf, ji = jax.jit(lambda v: jntt(v, jplan)), jax.jit(lambda v: jintt(v, jplan))
    ta, tb = to_lanes(a, True), to_lanes(b, True)
    fa = hm.merge_u64_fwd_plain(ta, plan)
    np.testing.assert_array_equal(from_lanes(fa, True), jfrom(jf(jto(a, True)), True))
    np.testing.assert_array_equal(from_lanes(hm.merge_u64_inv_plain(ta, plan), True),
                                  jfrom(ji(jto(a, True)), True))
    got = hm.merge_u64_polymul_inv_plain(fa, hm.merge_u64_fwd_plain(tb, plan), plan)
    prod = jax.jit(lambda u, v: jd.pointwise_mult_lanes(u, v, jplan))(
        jf(jto(a, True)), jf(jto(b, True)))
    np.testing.assert_array_equal(from_lanes(got, True), jfrom(ji(prod), True))


def test_plain_versions_reduce_any_input():
    """Like the TPU kernels, the forward and inverse take any u64 word
    and reduce it mod q first."""
    p = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = np.random.default_rng(4).integers(0, 1 << 64, size=(2, p.n), dtype=np.uint64,
                                          endpoint=False)
    xr = x % np.uint64(p.modulus.value)
    for fn in (hm.merge_u64_fwd_plain, hm.merge_u64_inv_plain):
        np.testing.assert_array_equal(from_lanes(fn(to_lanes(x, True), plan), True),
                                      from_lanes(fn(to_lanes(xr, True), plan), True))


# -------------------------------------------- the CUDA source, emulated

_SHIM = """
#pragma once
#include <cstdint>
#include <cstddef>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct EmuDim3 { unsigned x; };
static EmuDim3 threadIdx = {0}, blockIdx = {0};
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(n)
#define __restrict__
inline void __syncthreads() {}
inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> void emu_launch(long long grid, F f) {
  for (long long b = 0; b < grid; ++b) { blockIdx.x = (unsigned)b; f(); }
}
"""


def _emulated_source() -> str:
    """merge_u64.cu with one thread per block (each thread-strided loop
    then visits every index in order, and a stage's butterflies are
    independent) and every <<<grid, ...>>> launch a loop over blocks."""
    with open(os.path.join(CSRC, "merge_u64.cu")) as f:
        src = f.read()
    assert "constexpr int kThreads = 256;" in src
    src = src.replace("constexpr int kThreads = 256;", "constexpr int kThreads = 1;")
    launch = re.compile(r"(\w+(?:<\w+>)?)<<<(.+?), kThreads, 0, st>>>\(")
    out, i = [], 0
    while (m := launch.search(src, i)) is not None:
        j, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        out += [src[i:m.start()],
                f"emu_launch({m.group(2)}, [&] {{ {m.group(1)}({src[m.end():j]}; }})"]
        i = j
    assert len(out) == 12, "expected six kernel launches"
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulated kernels")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "merge_u64_emu.cpp").write_text(_emulated_source())
    shutil.copy(os.path.join(CSRC, "merge_u64.cuh"), d)
    so = d / "libemu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{d}",
                    "-o", str(so), str(d / "merge_u64_emu.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, u64, i32, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_longlong
    lib.merge_u64_forward.argtypes = [i32, p, p, i64, i32, i32, p, p, u64, u64, i32, p]
    lib.merge_u64_inverse.argtypes = [i32, p, p, i64, i32, i32, p, p, u64, u64, u64,
                                      u64, i32, p]
    lib.merge_u64_polymul_inverse.argtypes = [i32, p, p, p, i64, i32, i32, p, p, u64,
                                              i32, u64, u64, u64, i32, p]
    return lib


@pytest.mark.parametrize("poly", [tg.ReductionPolynomial.X_N_minus,
                                  tg.ReductionPolynomial.X_N_plus])
@pytest.mark.parametrize("logn", [12, 13, 14, 15, 16, 17])
def test_cuda_source_emulated_matches_plain(emulated, logn, poly):
    p = tg.NTTParameters(logn, poly, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    rng = np.random.default_rng(logn)
    x = to_lanes(rng.integers(0, 1 << 64, size=(2, p.n), dtype=np.uint64,
                              endpoint=False), True)
    b = to_lanes(data(p, 2, 7), True)
    la, q, one_s = hm.split(logn), plan.q, (1 << 64) // plan.q
    y, z, w = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    assert emulated.merge_u64_forward(0, x.data_ptr(), y.data_ptr(), 2, logn, la,
                                      plan.fwd_table.data_ptr(), plan.fwd_shoup.data_ptr(),
                                      q, one_s, int(plan.xnp), None) == 0
    assert torch.equal(y, hm.merge_u64_fwd_plain(x, plan))
    assert emulated.merge_u64_inverse(0, x.data_ptr(), z.data_ptr(), 2, logn, la,
                                      plan.inv_table.data_ptr(), plan.inv_shoup.data_ptr(),
                                      q, one_s, plan.n_inv, plan.n_inv_shoup,
                                      int(plan.xnp), None) == 0
    assert torch.equal(z, hm.merge_u64_inv_plain(x, plan))
    assert emulated.merge_u64_polymul_inverse(
        0, y.data_ptr(), b.data_ptr(), w.data_ptr(), 2, logn, la,
        plan.inv_table.data_ptr(), plan.inv_shoup.data_ptr(), q, plan.bit, plan.mu,
        plan.n_inv, plan.n_inv_shoup, int(plan.xnp), None) == 0
    assert torch.equal(w, hm.merge_u64_polymul_inv_plain(y, b, plan))


def test_cuda_source_emulated_refuses_bad_shapes(emulated):
    p = tg.NTTParameters(11, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = torch.zeros((1, p.n), dtype=torch.int64)
    rc = emulated.merge_u64_forward(0, x.data_ptr(), x.data_ptr(), 1, 11, 4,
                                    plan.fwd_table.data_ptr(), plan.fwd_shoup.data_ptr(),
                                    plan.q, 1, 1, None)
    assert rc == 1  # cudaErrorInvalidValue: logn 11 has no tile shape


# ------------------------------------------------------ wrapper contract


def test_wrappers_take_plain_versions_on_cpu_only():
    p = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_minus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = to_lanes(data(p, 2, 8), True)
    hm.reset_counts()
    fx = hm.merge_u64_fwd(x, plan)
    hm.merge_u64_inv(fx, plan)
    hm.merge_u64_polymul_inv(fx, fx, plan)
    assert [(k.launches, k.plain_calls) for k in hm.KERNELS] == [(0, 1)] * 3
    assert _build._lib is None  # nothing was built for CPU tensors

    meta = plan.to("meta")
    with pytest.raises(tg.NTTDeviceError):
        hm.merge_u64_fwd(torch.empty((2, p.n), dtype=torch.int64, device="meta"), meta)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.to(torch.int32), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.t(), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_polymul_inv(x, x[:1], plan)
    p11 = tg.NTTParameters(11, tg.ReductionPolynomial.X_N_minus, np.uint64)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x[:, :p11.n].contiguous(),
                         tg.MergePlan.from_params(p11, device="cpu"))


def test_route_table():
    def route(logn, dtype=np.uint64, shape=None, layout=tg.NTTLayout.PerPolynomial,
              factors=None):
        p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, dtype, factors=factors)
        plan = tg.MergePlan.from_params(p, device="cpu")
        return td._kernel_path(plan, shape or (4, p.n), layout)

    assert [route(n) for n in (11, 12, 16, 17, 18)] == \
        ["engine", "hopper-merge", "hopper-merge", "hopper-merge", "engine"]
    assert route(16, np.uint32) == "engine"
    assert route(12, shape=(2, 2, 4096)) == "engine"
    assert route(12, layout=tg.NTTLayout.PerCoefficient) == "engine"
    q62, = tg.find_ntt_primes(63, 12, 1)
    om, psi = tg.ntt_root_pair(q62, 12)
    assert route(12, factors=tg.NTTFactors(tg.Modulus64(q62), om, psi)) == "engine"
    q61, = tg.find_ntt_primes(62, 12, 1)
    om, psi = tg.ntt_root_pair(q61, 12)
    assert route(12, factors=tg.NTTFactors(tg.Modulus64(q61), om, psi)) == "hopper-merge"
