"""The port's utils/profiling.py on the CPU, held against the JAX package's.

`ntt_cost` field for field against gpuntt_tpu.utils.profiling.ntt_cost;
`trace` writes a Chrome trace a json reader takes, around a CPU ntt;
the probe's plain chain (`shoup_chain_plain`, and the `shoup_chain`
wrapper on a CPU tensor) bit for bit against a chain of the JAX
package's shoup_mul64 / shoup_mul32 on edge and random words; the probe
kernel's source, csrc/probe.cu, compiled by g++ through the host
emulation of tests/test_torch_merge.py, against the plain chain;
`measure_modmul_peak(device="cpu")` a finite positive rate.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu.ops import barrett as jb
from gpuntt_tpu.ops.limb import u64_from_numpy, u64_to_numpy
from gpuntt_tpu.utils.profiling import ntt_cost as jax_ntt_cost
from gpuntt_tpu_torch.common.errors import NTTDispatchError
from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64
from gpuntt_tpu_torch.utils import NTTCost, measure_modmul_peak, ntt_cost, profiling, trace
from gpuntt_tpu_torch.utils.kernel_bench import largest_ntt_prime

from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

Q64 = [576460756061519873, largest_ntt_prime(62, 17), (1 << 62) + 1 + (1 << 40) * 3]
Q32 = [469762049, largest_ntt_prime(30, 17), (1 << 31) - 1]


def _words(q, seed, n=300):
    """Edge words (0, 1, 2, q - 2, q - 1) and random words below q."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2, q - 2, q - 1], dtype=np.uint64)
    return np.concatenate([edge, rng.integers(0, q, size=n, dtype=np.uint64)])


def _ws(q, seed):
    return [1, 2, q - 1, int(np.random.default_rng(seed).integers(3, q - 1))]


@pytest.mark.parametrize("is64", [True, False])
def test_ntt_cost_matches_jax(is64):
    for logn in range(1, 29, 3):
        for batch in (1, 3, 128):
            got, want = ntt_cost(logn, batch, is64), jax_ntt_cost(logn, batch, is64)
            assert isinstance(got, NTTCost)
            assert vars(got) == vars(want)


def test_trace_writes_a_chrome_trace(tmp_path):
    p = tg.NTTParameters(10, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = np.random.default_rng(0).integers(0, p.modulus.value, (2, p.n), dtype=np.uint64)
    with trace(str(tmp_path / "t")):
        y = tg.ntt(x, plan)
    np.testing.assert_array_equal(y, tg.NTTCPU(p).ntt(x))
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("q", Q64)
def test_plain_chain64_matches_jax(q):
    x = _words(q, 1)
    for w in _ws(q, 2):
        ws = np.uint64((w << 64) // q)
        wj, wsj = u64_from_numpy(np.uint64(w)), u64_from_numpy(ws)
        for depth in (3, 4, 5):
            v = u64_from_numpy(x)
            for _ in range(depth):
                v = jb.shoup_mul64(v, wj, wsj, jb.u64_const(q))
            got = profiling.shoup_chain_plain(from_numpy_u64(x), w, q, depth, True)
            np.testing.assert_array_equal(to_numpy_u64(got), u64_to_numpy(v))
            wrapped = profiling.shoup_chain(from_numpy_u64(x), w, q, depth, True)
            np.testing.assert_array_equal(to_numpy_u64(wrapped), u64_to_numpy(v))


@pytest.mark.parametrize("q", Q32)
def test_plain_chain32_matches_jax(q):
    x = _words(q, 3).astype(np.uint32)
    for w in _ws(q, 4):
        ws = np.uint32((w << 32) // q)
        for depth in (3, 4, 5):
            v = jnp.asarray(x)
            for _ in range(depth):
                v = jb.shoup_mul32(v, jnp.uint32(w), jnp.uint32(ws), q)
            got = profiling.shoup_chain_plain(torch.from_numpy(x.astype(np.int64)), w, q,
                                              depth, False)
            np.testing.assert_array_equal(got.numpy(), np.asarray(v).astype(np.int64))


def test_chain_wrapper_counts_and_refuses():
    x = from_numpy_u64(_words(Q64[0], 5))
    profiling.reset_counts()
    profiling.shoup_chain(x, 3, Q64[0], 2, True)
    profiling.shoup_chain(x & 0xFFFF, 3, Q32[0], 2, False)
    assert [(k.launches, k.plain_calls) for k in profiling.KERNELS] == [(0, 1), (0, 1)]
    for w, q, is64 in ((0, Q64[0], True), (Q64[0], Q64[0], True), (5, 1 << 63, True),
                       (5, 1 << 31, False)):
        with pytest.raises(NTTDispatchError):
            profiling.shoup_chain(x, w, q, 2, is64)
    with pytest.raises(NTTDispatchError):
        profiling.shoup_chain(x.view(-1, 5), 3, Q64[0], 2, True)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulate(tmp_path_factory, "probe")


@pytest.mark.parametrize("is64", [True, False])
def test_cuda_source_emulated_matches_plain(emulated, is64):
    """csrc/probe.cu on the host (one thread a block): both entries at
    every q of the word against the plain chain, on a ragged word count,
    depths 0-5; invalid arguments return cudaErrorInvalidValue."""
    import ctypes

    entry = emulated.shoup_chain_u64 if is64 else emulated.shoup_chain_u32
    for q in Q64 if is64 else Q32:
        x = from_numpy_u64(_words(q, 6, n=1021))
        for w in _ws(q, 7):
            for depth in (0, 1, 5):
                y = torch.empty_like(x)
                rc = entry(0, x.data_ptr(), y.data_ptr(), x.numel(), depth, w,
                           profiling.companion(w, q, is64), q, ctypes.c_void_p(0))
                assert rc == 0
                want = profiling.shoup_chain_plain(x, w, q, depth, is64)
                assert torch.equal(y, want), (q, w, depth)
    y = torch.empty_like(x)
    for args in ((x.numel(), 1, q, 0, q), (0, 1, 3, 0, q), (x.numel(), -1, 3, 0, q)):
        n, depth, w, ws, qq = args
        assert entry(0, x.data_ptr(), y.data_ptr(), n, depth, w, ws, qq,
                     ctypes.c_void_p(0)) == 1


@pytest.mark.parametrize("is64", [True, False])
def test_measure_modmul_peak_on_the_cpu(is64):
    rate = measure_modmul_peak(Q64[0] if is64 else Q32[0], is64, depth=3, elems=(4, 256),
                               device="cpu")
    assert np.isfinite(rate) and rate > 0


def test_chip_smoke_probe_phase_rehearses_on_the_cpu(capsys):
    """chip_smoke.py's probe phase on the host: the plain chain through the
    wrapper against itself at both words and q of the phase (the rates
    are read on the card only)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.probe_phase(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("== plain version (max |diff| 0)") == 12
    assert "measure_modmul_peak" not in out
