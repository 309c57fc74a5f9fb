"""The port's host layers against gpuntt_tpu's (CPU, exact equality).

The port copies the jax-free host layers (importing any gpuntt_tpu
submodule imports jax); these tests pin the copies to the originals
byte for byte and check that both packages give identical pools,
tables and golden outputs on sampled (logn, dtype, poly) cells.  They
also hold the port to importing no jax and running without it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch import _native
from gpuntt_tpu_torch.common.device import available_devices, default_device

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gpuntt_tpu_torch")
MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus
TPOLY = {MINUS: tg.ReductionPolynomial.X_N_minus, PLUS: tg.ReductionPolynomial.X_N_plus}

COPIES = [
    "common/errors.py", "common/check.py", "arith/__init__.py",
    "arith/modulus.py", "arith/host.py", "params/bitrev.py", "params/merge.py",
    "_native/nttref.cpp", "reference/vecmod.py", "reference/merge_cpu.py",
    "reference/schoolbook.py", "params/fourstep.py", "reference/fourstep_cpu.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    with open(os.path.join(ROOT, "gpuntt_tpu", rel), "rb") as f:
        orig = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == orig


CELLS = [(1, np.uint64, MINUS), (5, np.uint32, PLUS), (10, np.uint64, PLUS),
         (12, np.uint32, MINUS), (16, np.uint64, MINUS), (17, np.uint64, PLUS)]


@pytest.mark.parametrize("logn,dtype,poly", CELLS)
def test_pools_and_tables_match(logn, dtype, poly):
    jp = jg.NTTParameters(logn, poly, dtype)
    tp = tg.NTTParameters(logn, TPOLY[poly], dtype)
    for a in ("n", "omega", "psi", "root_of_unity", "inverse_root_of_unity",
              "root_of_unity_size", "n_inv"):
        assert getattr(tp, a) == getattr(jp, a), a
    assert (tp.modulus.value, tp.modulus.bit, tp.modulus.mu) == \
        (jp.modulus.value, jp.modulus.bit, jp.modulus.mu)
    for fwd in (True, False):
        got = tp.gpu_root_of_unity_table(fwd)
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, jp.gpu_root_of_unity_table(fwd))


@pytest.mark.parametrize("logn,dtype,poly", CELLS[1:5])
def test_golden_models_match(logn, dtype, poly):
    rng = np.random.default_rng(logn)
    jp = jg.NTTParameters(logn, poly, dtype)
    tp = tg.NTTParameters(logn, TPOLY[poly], dtype)
    jc, tc = jg.NTTCPU(jp), tg.NTTCPU(tp)
    x = rng.integers(0, jp.modulus.value, size=(2, jp.n), dtype=np.uint64).astype(dtype)
    y = rng.integers(0, jp.modulus.value, size=(2, jp.n), dtype=np.uint64).astype(dtype)
    fx = tc.ntt(x)
    np.testing.assert_array_equal(fx, jc.ntt(x))
    np.testing.assert_array_equal(tc.intt(fx), jc.intt(fx))
    np.testing.assert_array_equal(tc.mult(fx, y), jc.mult(fx, y))
    if logn <= 10:
        np.testing.assert_array_equal(
            tg.schoolbook_poly_multiplication(x[0], y[0], tp.modulus, TPOLY[poly]),
            jg.schoolbook_poly_multiplication(x[0], y[0], jp.modulus, poly))


def test_prime_search_roots_and_crt_match():
    for bits, logn in ((30, 12), (46, 14), (62, 14)):
        qs = tg.find_ntt_primes(bits, logn, 3)
        assert qs == jg.find_ntt_primes(bits, logn, 3)
        assert all(tg.is_prime_u64(q) for q in qs)
        assert tg.ntt_root_pair(qs[0], logn) == jg.ntt_root_pair(qs[0], logn)
    qs = tg.find_ntt_primes(40, 4, 2)
    res = np.random.default_rng(3).integers(0, 1 << 39, size=(2, 16), dtype=np.uint64)
    assert tg.crt_reconstruct(res, qs) == jg.crt_reconstruct(res, qs)


def test_errors_and_check_result():
    with pytest.raises(tg.NTTParameterError):
        tg.NTTParameters(26, tg.ReductionPolynomial.X_N_minus, np.uint32)
    with pytest.raises(tg.NTTParameterError):
        tg.NTTParameters(29, tg.ReductionPolynomial.X_N_minus, np.uint64)
    assert tg.check_result(np.arange(4), np.arange(4))
    assert not tg.check_result(np.arange(4), np.arange(1, 5), verbose=False)


def test_native_core_builds_outside_tracked_tree():
    assert _native.available()
    so = _native._so_path()
    assert os.path.dirname(so) == os.path.join(PORT, "_native", "build")
    assert os.path.exists(so)
    assert _native.power_table(3, 97, 8).tolist() == [pow(3, i, 97) for i in range(8)]


@pytest.mark.parametrize("n1,n2", [(32, 128), (64, 512)])
def test_fourstep_native_bindings_match(n1, n2):
    """The four bindings the 4-step golden model calls, against
    gpuntt_tpu._native's on the same inputs."""
    from gpuntt_tpu import _native as jnative

    logn = (n1 * n2).bit_length() - 1
    p = tg.NTTParameters4Step(logn, tg.ReductionPolynomial.X_N_minus, np.uint64,
                              dims=(n1, n2))
    q = p.modulus.value
    x = np.random.default_rng(n1).integers(0, q, size=(n1, n2), dtype=np.uint64)
    for name, table in (("core_ntt_rows", p.n2_based_root_of_unity_table),
                        ("core_intt_rows", p.n2_based_inverse_root_of_unity_table)):
        got = getattr(_native, name)(x, table, q)
        np.testing.assert_array_equal(got, getattr(jnative, name)(x, table, q), err_msg=name)
        assert not np.array_equal(got, x)
    for name, root in (("w_table_forward", p.root_of_unity),
                       ("w_table_inverse", p.inverse_root_of_unity)):
        got = getattr(_native, name)(root, q, n1, n2)
        np.testing.assert_array_equal(got, getattr(jnative, name)(root, q, n1, n2),
                                      err_msg=name)
    assert got[n2 + 1] == pow(p.inverse_root_of_unity, n2 // 2, q)  # iroot^(1 * br(1))
    # the parameters' W table: the bindings at n >= 2^14, Python below
    np.testing.assert_array_equal(p.W_inverse_root_of_unity_table, got)


def test_devices_on_this_host():
    """The default device is the card; without one, a plan or model made
    for it raises instead of quietly running on the host."""
    assert available_devices("cpu") == [torch.device("cpu")]
    p = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus, np.uint32)
    if torch.cuda.is_available():
        assert default_device() == torch.device("cuda", 0)
        assert tg.MergePlan.from_params(p).device.type == "cuda"
        assert "power_limit=" in tg.device_summary()
    else:
        for make in (default_device, lambda: available_devices("cuda"),
                     lambda: tg.MergePlan.from_params(p),
                     lambda: tg.PolynomialMultiplier(p)):
            with pytest.raises(tg.NTTDeviceError):
                make()
        assert available_devices() == [torch.device("cpu")]
        assert "platform=cpu" in tg.device_summary()
    assert tg.MergePlan.from_params(p, device="cpu").device == torch.device("cpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "gpuntt_tpu")]
    assert not bad


def test_port_runs_with_jax_unavailable():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['gpuntt_tpu'] = None\n"
        "import numpy as np, gpuntt_tpu_torch as g\n"
        "p = g.NTTParameters(12, g.ReductionPolynomial.X_N_plus, np.uint64)\n"
        "x = np.random.default_rng(0).integers(0, p.modulus.value, (2, p.n),"
        " dtype=np.uint64)\n"
        "y = g.ntt(x, g.MergePlan.from_params(p, device='cpu'))\n"
        "assert np.array_equal(y, g.NTTCPU(p).ntt(x))\n"
        "p = g.NTTParameters(10, g.ReductionPolynomial.X_N_minus, np.uint32)\n"
        "x = x[:, :p.n].astype(np.uint32) % np.uint32(p.modulus.value)\n"
        "plan = g.MergePlan.from_params(p, device='cpu')\n"
        "assert np.array_equal(g.ntt(x, plan), g.NTTCPU(p).ntt(x))\n"
        "assert np.array_equal(g.intt(g.ntt(x, plan), plan), x)\n"
        "from gpuntt_tpu_torch.ops import hopper_merge32 as h\n"
        "assert h.FORWARD['K4'].plain_calls == 2 and h.INVERSE['K4'].plain_calls == 1\n"
        "p = g.NTTParameters4Step(14, g.ReductionPolynomial.X_N_plus, np.uint64)\n"
        "x = np.random.default_rng(1).integers(0, p.modulus.value, (2, p.n), dtype=np.uint64)\n"
        "plan = g.FourStepPlan.from_params(p, device='cpu')\n"
        "from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64\n"
        "y = to_numpy_u64(g.fourstep_ntt_full(from_numpy_u64(x), plan))\n"
        "assert np.array_equal(y, np.stack([g.NTT4StepCPU(p).ntt(r) for r in x]))\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "print('ran')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ran"
