"""The port's merge engine and main-path kernels (CPU, exact equality).

- The torch butterfly engine against the JAX XLA engine at logn 2-11,
  u32 and u64, both polys, plus caller factors that are no root of
  unity; plans carried across with MergePlan.from_arrays.
- The plain versions of the three kernels against the Pallas kernels
  they replace (interpret mode, one logn-12 cell) and against the JAX
  engine's merge_ntt_lanes / merge_intt_lanes, and what polymul_lanes
  computes off the TPU, at logn 12-14 (polymul_lanes itself is called
  in test_torch_slice.py).
- The CUDA sources themselves, merge_u64.cu, merge_u64_large.cu and
  merge_u32.cu, compiled by g++ through a host emulation of the few CUDA
  constructs they use (one thread per block, blocks in order, dynamic
  shared memory a host array), against the plain versions: u64 at logn
  11-17, the big-ring column and row kernels at small splits (A = 4..512,
  B = 8..2048, a nested plan), u32 at every tile shape of its split rule
  (logn 8-23).  This checks the kernels' index arithmetic, twiddle
  addressing and shape refusals without a card.
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
from gpuntt_tpu_torch.ops import barrett as bo
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
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
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct EmuDim3 { unsigned x; };
static EmuDim3 threadIdx = {0}, blockIdx = {0};
static uint32_t emu_smem[1 << 15];  // the largest dynamic tiles, u32 ...
alignas(16) static uint64_t emu_smem64[1 << 13];  // ... and u64
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
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <class F> void emu_launch(long long grid, F f) {
  for (long long b = 0; b < grid; ++b) { blockIdx.x = (unsigned)b; f(); }
}
"""

# library -> launch sites in its source
_LAUNCHES = {"merge_u64": 4, "merge_u64_large": 4, "merge_u32": 4, "fourstep": 1}


def _emulated_source(name: str) -> str:
    """csrc/<name>.cu with one thread per block (each thread-strided loop
    then visits every index in order, and a stage's butterflies are
    independent), dynamic shared memory one host array, and every
    <<<grid, kThreads, bytes, st>>> launch a loop over blocks."""
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = f.read()
    assert "constexpr int kThreads = 256;" in src
    src = src.replace("constexpr int kThreads = 256;", "constexpr int kThreads = 1;")
    src = src.replace("extern __shared__ uint32_t smem[];", "uint32_t* smem = emu_smem;")
    src = src.replace("extern __shared__ uint64_t smem[];", "uint64_t* smem = emu_smem64;")
    launch = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<(.+?), kThreads, \w+, st>>>\(")
    out, i = [], 0
    while (m := launch.search(src, i)) is not None:
        j, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            j += 1
        out += [src[i:m.start()],
                f"emu_launch({m.group(2)}, [&] {{ {m.group(1)}({src[m.end():j]}; }})"]
        i = j
    assert len(out) == 2 * _LAUNCHES[name], f"expected {_LAUNCHES[name]} launches"
    return "".join(out) + src[i:]


def _emulate(tmp_path_factory, name: str) -> ctypes.CDLL:
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulated kernels")
    d = tmp_path_factory.mktemp(f"emu_{name}")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / f"{name}_emu.cpp").write_text(_emulated_source(name))
    for header in os.listdir(CSRC):
        if header.endswith(".cuh"):
            shutil.copy(os.path.join(CSRC, header), d)
    so = d / "libemu.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{d}",
                    "-o", str(so), str(d / f"{name}_emu.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build._ENTRIES[name].items():
        getattr(lib, entry).argtypes = argtypes
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulate(tmp_path_factory, "merge_u64")


@pytest.fixture(scope="module")
def emulated32(tmp_path_factory):
    return _emulate(tmp_path_factory, "merge_u32")


@pytest.fixture(scope="module")
def emulated_large(tmp_path_factory):
    return _emulate(tmp_path_factory, "merge_u64_large")


@pytest.mark.parametrize("poly", [tg.ReductionPolynomial.X_N_minus,
                                  tg.ReductionPolynomial.X_N_plus])
@pytest.mark.parametrize("logn", [11, 12, 13, 14, 15, 16, 17])
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
    p = tg.NTTParameters(10, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = torch.zeros((1, p.n), dtype=torch.int64)
    rc = emulated.merge_u64_forward(0, x.data_ptr(), x.data_ptr(), 1, 10, 3,
                                    plan.fwd_table.data_ptr(), plan.fwd_shoup.data_ptr(),
                                    plan.q, 1, 1, None)
    assert rc == 1  # cudaErrorInvalidValue: logn 10 has no tile shape


def _emulated_steps(lib, lib64):
    """hopper_merge_large's composition with every kernel the emulated
    CUDA source: K7 and K8 from merge_u64_large.cu, K1-K3 from
    merge_u64.cu."""
    def col(entry, inverse):
        def run(x, lp):
            c, y = lp.col, torch.empty_like(x)
            tabs = ((c.inv_table, c.inv_shoup, lp.wt_inv, lp.wt_inv_shoup, lp.ws_inv,
                     lp.ws_inv_shoup) if inverse else
                    (c.fwd_table, c.fwd_shoup, lp.wt_fwd, lp.wt_fwd_shoup, lp.ws_fwd,
                     lp.ws_fwd_shoup))
            scale = (c.n_inv, c.n_inv_shoup) if inverse else ()
            assert getattr(lib, entry)(
                0, x.data_ptr(), y.data_ptr(), x.shape[0], c.logn, lp.B.bit_length() - 1,
                *(t.data_ptr() for t in tabs), lp.tile.bit_length() - 1, lp.q,
                (1 << 64) // lp.q, *scale, int(c.xnp), None) == 0
            return y
        return run

    def rowmat(x, plan, inverse):
        table, shoup = ((plan.inv_table, plan.inv_shoup) if inverse
                        else (plan.fwd_table, plan.fwd_shoup))
        y = torch.empty_like(x)
        assert lib.merge_u64_large_rowmat(
            0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn, table.data_ptr(),
            shoup.data_ptr(), plan.q, (1 << 64) // plan.q, plan.n_inv, plan.n_inv_shoup,
            int(inverse), int(plan.xnp), None) == 0
        return y

    def rows(inverse):
        def run(x, plan):
            y, la = torch.empty_like(x), hm.split(plan.logn)
            table, shoup = ((plan.inv_table, plan.inv_shoup) if inverse
                            else (plan.fwd_table, plan.fwd_shoup))
            args = (plan.q, (1 << 64) // plan.q) + (
                (plan.n_inv, plan.n_inv_shoup) if inverse else ())
            entry = lib64.merge_u64_inverse if inverse else lib64.merge_u64_forward
            assert entry(0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn, la,
                         table.data_ptr(), shoup.data_ptr(), *args, int(plan.xnp),
                         None) == 0
            return y
        return run

    return hml._Steps(col("merge_u64_large_colfwd", False),
                      col("merge_u64_large_colinv", True), rowmat, rows(False), rows(True),
                      None)


# (logn, a_col, tile, max_row_logn): every shape class of the big-ring kernels
LARGE_EMULATED = [
    (8, 4, 16, 17),      # K8 rows of 64, a factored W of four tiles
    (9, 16, 8, 17),      # a wider column tile over rows of 32
    (12, 512, None, 17),  # A = 512 (the largest column), rows of 8, C = B
    (16, 256, None, 17),  # C = 32 columns of 256 per block, K8 rows of 256
    (15, 16, 256, 17),   # rows of 2^11 on the logn-11 K1/K2
    (14, 8, None, 9),    # rows of 2^11 beyond max_row_logn: a nested 4 x 512 plan
]


@pytest.mark.parametrize("poly", [tg.ReductionPolynomial.X_N_minus,
                                  tg.ReductionPolynomial.X_N_plus])
@pytest.mark.parametrize("logn,a_col,tile,max_row", LARGE_EMULATED)
def test_cuda_source_large_emulated_matches_plain(emulated_large, emulated, logn, a_col,
                                                  tile, max_row, poly):
    """merge_u64_large.cu's three entries, each against its plain version
    on any u64 word, and the whole composition through the emulated
    sources against the plain composition."""
    p = tg.NTTParameters(logn, poly, np.uint64)
    q = p.modulus.value
    lp = hml.LargePlan.from_spec(q, logn, p.root_of_unity, p.inverse_root_of_unity,
                                 poly == tg.ReductionPolynomial.X_N_plus, p.n_inv,
                                 a_col=a_col, tile=tile, max_row_logn=max_row,
                                 row_kwargs=dict(a_col=4), device="cpu")
    x = to_lanes(np.random.default_rng(logn).integers(0, 1 << 64, size=(2, p.n),
                                                       dtype=np.uint64), True)
    steps = _emulated_steps(emulated_large, emulated)
    assert torch.equal(steps.colfwd(x, lp), hml.colfwd_plain(x, lp))
    assert torch.equal(steps.colinv(x, lp), hml.colinv_plain(x, lp))
    if lp.row_kernel == "K8":
        r = x.reshape(-1, lp.B)[:-3].contiguous()  # the last block short of rows
        for inverse in (False, True):
            assert torch.equal(steps.rowmat(r, lp.rows, inverse),
                               hml.rowmat_plain(r, lp.rows, inverse))
    fx = hml._transform(x, lp, False, steps)
    assert torch.equal(fx, hml.merge_u64_large_plain(x, lp))
    assert torch.equal(hml._transform(fx, lp, True, steps), bo.reduce_forced64(x, q))


@pytest.mark.parametrize("entry,args", [
    ("colfwd", dict(logA=10)),        # A = 1024: past the 2^13-word tile at C = 8
    ("colfwd", dict(logA=0)),         # no column stage
    ("colinv", dict(logT=7)),         # a tile wider than the rows
    ("colinv", dict(batch=0)),
    ("rowmat", dict(logB=10)),        # K8 rows of 1024: past its 512
    ("rowmat", dict(batch=0)),
])
def test_cuda_source_large_emulated_refuses_bad_shapes(emulated_large, entry, args):
    x = torch.zeros(1 << 14, dtype=torch.int64)
    a = dict(batch=1, logA=3, logB=6, logT=4) | args
    p = x.data_ptr()
    if entry == "rowmat":
        rc = emulated_large.merge_u64_large_rowmat(0, p, p, a["batch"], a["logB"], p, p,
                                                   97, 1, 1, 1, 0, 0, None)
    else:
        scale = (1, 1) if entry == "colinv" else ()
        rc = getattr(emulated_large, f"merge_u64_large_{entry}")(
            0, p, p, a["batch"], a["logA"], a["logB"], p, p, p, p, p, p, a["logT"], 97, 1,
            *scale, 0, None)
    assert rc == 1  # cudaErrorInvalidValue


U32_EMULATED = [(logn, poly, 2) for logn in (7, 8, 12, 16, 17, 18)
                for poly in (tg.ReductionPolynomial.X_N_minus,
                             tg.ReductionPolynomial.X_N_plus)] + [
    (7, tg.ReductionPolynomial.X_N_minus, 130),  # the 4-step's rows of 128: 64 a block
    (8, tg.ReductionPolynomial.X_N_plus, 33),  # two blocks of rings, one short
    (22, tg.ReductionPolynomial.X_N_minus, 1), (22, tg.ReductionPolynomial.X_N_plus, 1),
    (23, tg.ReductionPolynomial.X_N_plus, 1)]  # the 128 KiB tile


@pytest.mark.parametrize("logn,poly,batch", U32_EMULATED)
def test_cuda_source_u32_emulated_matches_plain(emulated32, logn, poly, batch):
    """merge_u32.cu's two entries on any u32 word, at every tile shape of
    the split rule: one launch over whole rings (7, 8, 12; logn 7 is the
    4-step's rows), the 32 KiB two-phase tiles (16-22) and the 128 KiB
    one (23)."""
    p = tg.NTTParameters(logn, poly, np.uint32)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = torch.from_numpy(np.random.default_rng(logn).integers(
        0, 1 << 32, size=(batch, p.n), dtype=np.int64))
    la, q, one_s = hm32.split(logn), plan.q, (1 << 32) // plan.q
    y, z = torch.empty_like(x), torch.empty_like(x)
    assert emulated32.merge_u32_forward(0, x.data_ptr(), y.data_ptr(), batch, logn, la,
                                        plan.fwd_table.data_ptr(),
                                        plan.fwd_shoup.data_ptr(), q, one_s,
                                        int(plan.xnp), None) == 0
    assert torch.equal(y, hm32.merge_u32_fwd_plain(x, plan))
    # the plain inverse takes seconds on the CPU from 2^22 on: there the
    # inverse is held to the round trip of the forward just checked
    src = x if logn < 22 else y
    assert emulated32.merge_u32_inverse(0, src.data_ptr(), z.data_ptr(), batch, logn, la,
                                        plan.inv_table.data_ptr(),
                                        plan.inv_shoup.data_ptr(), q, one_s, plan.n_inv,
                                        plan.n_inv_shoup, int(plan.xnp), None) == 0
    assert torch.equal(z, hm32.merge_u32_inv_plain(x, plan) if logn < 22 else x % q)


@pytest.mark.parametrize("logn,log_a,batch", [
    (20, 0, 1),   # rows of 2^20 words: no tile holds them
    (12, 2, 1),   # columns of a 2^13-word tile wider than the 2^10-word rows
    (14, 1, 0),   # empty batch
])
def test_cuda_source_u32_emulated_refuses_bad_shapes(emulated32, logn, log_a, batch):
    p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, np.uint32)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = torch.zeros((1, p.n), dtype=torch.int64)
    for rc in (
            emulated32.merge_u32_forward(0, x.data_ptr(), x.data_ptr(), batch, logn, log_a,
                                         plan.fwd_table.data_ptr(),
                                         plan.fwd_shoup.data_ptr(), plan.q, 1, 1, None),
            emulated32.merge_u32_inverse(0, x.data_ptr(), x.data_ptr(), batch, logn, log_a,
                                         plan.inv_table.data_ptr(),
                                         plan.inv_shoup.data_ptr(), plan.q, 1, 1, 1, 1,
                                         None)):
        assert rc == 1  # cudaErrorInvalidValue


@pytest.fixture(scope="module")
def emulated_fourstep(tmp_path_factory):
    return _emulate(tmp_path_factory, "fourstep")


def _fourstep_col(lib, x, kp, inverse):
    c, y = kp.col, torch.empty_like(x)
    tabs = ((c.inv_table, c.inv_shoup, kp.wt_inv, kp.wt_inv_shoup, kp.ws_inv,
             kp.ws_inv_shoup) if inverse else
            (c.fwd_table, c.fwd_shoup, kp.wt_fwd, kp.wt_fwd_shoup, kp.ws_fwd,
             kp.ws_fwd_shoup))
    word = "u64" if kp.is64 else "u32"
    assert getattr(lib, f"fourstep_{word}_col_{'inv' if inverse else 'fwd'}")(
        0, x.data_ptr(), y.data_ptr(), x.shape[0], kp.n1.bit_length() - 1,
        kp.n2.bit_length() - 1, kp.tile.bit_length() - 1, kp.w_tile.bit_length() - 1,
        *(t.data_ptr() for t in tabs), kp.q, (1 << (64 if kp.is64 else 32)) // kp.q,
        None) == 0
    return y


def _fourstep_kplan(logn, dims, dtype, poly):
    from gpuntt_tpu_torch.ops import fourstep as tf
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf

    p = tg.NTTParameters4Step(logn, poly, dtype, dims=dims)
    return hf.kernel_plan(tf.FourStepPlan.from_params(p, device="cpu"))


# (logn, n1, n2): every n1 of MATRIX_DIMENSIONS (32-256) and the largest
# the kernels take (512), with several tiles of rows where n2 allows
FOURSTEP_EMULATED = [(14, 32, 512), (13, 64, 128), (13, 128, 64), (14, 256, 64),
                     (13, 512, 16)]


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("logn,n1,n2", FOURSTEP_EMULATED)
def test_cuda_source_fourstep_emulated_matches_plain(emulated_fourstep, logn, n1, n2,
                                                     dtype):
    """fourstep.cu's column entries (K9 and K11's column twin), both
    directions, on any input word, against the plain version."""
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf

    kp = _fourstep_kplan(logn, (n1, n2), dtype, tg.ReductionPolynomial.X_N_plus)
    hi = 1 << (64 if kp.is64 else 32)
    x = to_lanes(np.random.default_rng(logn + n1).integers(0, hi, size=(2, kp.n),
                                                            dtype=np.uint64), True)
    for inverse in (False, True):
        assert torch.equal(_fourstep_col(emulated_fourstep, x, kp, inverse),
                           hf.col_plain(x, kp, inverse))


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
@pytest.mark.parametrize("logn", [12, 17])
def test_cuda_source_fourstep_composition_emulated(emulated_fourstep, emulated_large,
                                                   emulated, emulated32, logn, dtype):
    """The whole 4-step through emulated sources — the column kernels of
    fourstep.cu, then rows of 128 words (logn 12: K10 on merge_u64_large.cu's
    row entry, K11's row twin on merge_u32.cu) or 4096 (logn 17: K1/K2 on
    merge_u64.cu, the u32 family) — against the plain composition."""
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf

    kp = _fourstep_kplan(logn, None, dtype, tg.ReductionPolynomial.X_N_minus)

    def row64(x, plan, inverse):
        table, shoup = ((plan.inv_table, plan.inv_shoup) if inverse
                        else (plan.fwd_table, plan.fwd_shoup))
        y = torch.empty_like(x)
        assert emulated_large.merge_u64_large_rowmat(
            0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn, table.data_ptr(),
            shoup.data_ptr(), plan.q, (1 << 64) // plan.q, plan.n_inv, plan.n_inv_shoup,
            int(inverse), 0, None) == 0
        return y

    def u32(inverse):
        def run(x, plan, *_):
            y, table, shoup = ((torch.empty_like(x), plan.inv_table, plan.inv_shoup)
                               if inverse else
                               (torch.empty_like(x), plan.fwd_table, plan.fwd_shoup))
            scale = (plan.n_inv, plan.n_inv_shoup) if inverse else ()
            entry = emulated32.merge_u32_inverse if inverse else emulated32.merge_u32_forward
            assert entry(0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn,
                         hm32.split(plan.logn), table.data_ptr(), shoup.data_ptr(), plan.q,
                         (1 << 32) // plan.q, *scale, 0, None) == 0
            return y
        return run

    def u64(inverse):
        def run(x, plan):
            y, table, shoup = ((torch.empty_like(x), plan.inv_table, plan.inv_shoup)
                               if inverse else
                               (torch.empty_like(x), plan.fwd_table, plan.fwd_shoup))
            scale = (plan.n_inv, plan.n_inv_shoup) if inverse else ()
            entry = emulated.merge_u64_inverse if inverse else emulated.merge_u64_forward
            assert entry(0, x.data_ptr(), y.data_ptr(), x.shape[0], plan.logn,
                         hm.split(plan.logn), table.data_ptr(), shoup.data_ptr(), plan.q,
                         (1 << 64) // plan.q, *scale, 0, None) == 0
            return y
        return run

    def col(x, kp, inverse):
        return _fourstep_col(emulated_fourstep, x, kp, inverse)

    steps = (hf._Steps(col, row64, u64(False), u64(True)) if kp.is64 else
             hf._Steps(col, lambda x, plan, inverse: u32(inverse)(x, plan),
                       u32(False), u32(True)))
    x = to_lanes(data(tg.NTTParameters4Step(logn, dtype=dtype), 2, logn), kp.is64)
    for inverse in (False, True):
        assert torch.equal(hf._transform(x, kp, inverse, steps),
                           hf.fourstep_plain(x, kp, inverse))


@pytest.mark.parametrize("word,args", [
    ("u64", dict(log1=10, logT=2)),          # n1 = 1024: past the column kernels' 512
    ("u32", dict(log1=10, logT=3)),
    ("u64", dict(batch=1 << 20, log2=20)),   # 2^36 blocks: past the grid's 2^31
    ("u64", dict(log1=5, logT=8)),           # a 2^13-word u64 tile: past 32 KiB
    ("u32", dict(logT=7)),                   # a tile of more rows than the ring has
    ("u64", dict(logTw=7)),                  # a W tile wider than the rows
    ("u32", dict(batch=0)),
])
def test_cuda_source_fourstep_emulated_refuses_bad_shapes(emulated_fourstep, word, args):
    x = torch.zeros(1 << 14, dtype=torch.int64)
    a = dict(batch=1, log1=3, log2=6, logT=4, logTw=3) | args
    p = x.data_ptr()
    for d in ("fwd", "inv"):
        rc = getattr(emulated_fourstep, f"fourstep_{word}_col_{d}")(
            0, p, p, a["batch"], a["log1"], a["log2"], a["logT"], a["logTw"], p, p, p, p, p,
            p, 97, 1, None)
        assert rc == 1  # cudaErrorInvalidValue


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
    assert _build._libs == {}  # nothing was built for CPU tensors

    meta = plan.to("meta")
    with pytest.raises(tg.NTTDeviceError):
        hm.merge_u64_fwd(torch.empty((2, p.n), dtype=torch.int64, device="meta"), meta)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.to(torch.int32), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_fwd(x.t(), plan)
    with pytest.raises(tg.NTTDispatchError):
        hm.merge_u64_polymul_inv(x, x[:1], plan)
    p10 = tg.NTTParameters(10, tg.ReductionPolynomial.X_N_minus, np.uint64)
    with pytest.raises(tg.NTTDispatchError):  # logn 11 is the kernels' smallest ring
        hm.merge_u64_fwd(x[:, :p10.n].contiguous(),
                         tg.MergePlan.from_params(p10, device="cpu"))


def test_route_table():
    def route(logn, dtype=np.uint64, shape=None, layout=tg.NTTLayout.PerPolynomial,
              factors=None):
        p = tg.NTTParameters(logn, tg.ReductionPolynomial.X_N_plus, dtype, factors=factors)
        plan = tg.MergePlan.from_params(p, device="cpu")
        return td._kernel_path(plan, shape or (4, p.n), layout)

    assert [route(n) for n in (11, 12, 16, 17, 18)] == \
        ["engine", "hopper-merge", "hopper-merge", "hopper-merge", "hopper-merge-large"]
    assert route(16, np.uint32) == "hopper-merge32"  # the rest in test_torch_merge32.py
    assert route(12, shape=(2, 2, 4096)) == "engine"
    assert route(12, layout=tg.NTTLayout.PerCoefficient) == "engine"
    q62, = tg.find_ntt_primes(63, 12, 1)
    om, psi = tg.ntt_root_pair(q62, 12)
    assert route(12, factors=tg.NTTFactors(tg.Modulus64(q62), om, psi)) == "engine"
    q61, = tg.find_ntt_primes(62, 12, 1)
    om, psi = tg.ntt_root_pair(q61, 12)
    assert route(12, factors=tg.NTTFactors(tg.Modulus64(q61), om, psi)) == "hopper-merge"
