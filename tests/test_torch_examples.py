"""The port's examples (gpuntt_tpu_torch/examples) and its entry
(gpuntt_tpu_torch/entry.py) on the CPU, held against the JAX package.

One subprocess (`ran`, module scope) imports with `jax` and `gpuntt_tpu`
blocked in sys.modules and runs every example's main with --device=cpu
at the sizes of tests/test_examples.py, then `entry.main(["4",
"reduced", "--device=cpu"])`: each prints `All Correct.` and returns 0.
In this process each device example's `compute` is held bit for bit to
the JAX package, with the JAX script's seed and draw order, through
its golden models (XLA compiles of these calls take 5-60 s each on the
CPU, minutes for the dist functions; the route's own test files hold
the port to the XLA engine), and the entry's step to `__graft_entry__.entry()`'s under jax.jit.  The
CUDA-graph capture needs a card: tests/test_torch_cuda.py runs it.
"""

import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu_torch import entry as E
from gpuntt_tpu_torch.common.errors import NTTDeviceError
from gpuntt_tpu_torch.ops.limb import to_numpy_u64

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CPU = torch.device("cpu")
JMINUS, JPLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus

# tests/test_examples.py's sizes
SIZES = {"example_cpu_merge_ntt": (9, 1), "example_cpu_4step_ntt": (12, 1),
         "example_merge_ntt": (9, 2), "example_merge_intt": (9, 2),
         "example_4step_ntt": (12, 2), "example_4step_intt": (12, 2),
         "example_rns_ntt": (12, 4), "example_rns_polymul": (8, 2),
         "example_distributed_polymul": (12, 2)}

_CHILD = """
import contextlib, io, json, sys
sys.modules['jax'] = None
sys.modules['gpuntt_tpu'] = None
import importlib
sizes = json.loads(sys.argv[1])

def run(name, fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    print(json.dumps({"name": name, "rc": rc, "out": buf.getvalue()}), flush=True)

for name, (logn, batch) in sizes.items():
    mod = importlib.import_module("gpuntt_tpu_torch.examples." + name)
    run(name, mod.main, [str(logn), str(batch), "--device=cpu"])
from gpuntt_tpu_torch import entry
print(json.dumps({"name": "entry", "rc": entry.main(["4", "reduced", "--device=cpu"])}))
loaded = sorted({m.split('.')[0] for m in sys.modules if sys.modules[m]})
print(json.dumps({"name": "modules", "top": loaded}))
"""


@pytest.fixture(scope="module")
def ran():
    """{name: record} of the jax-free subprocess, and its whole stdout."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    env.pop("PYTEST_CURRENT_TEST", None)
    r = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(SIZES)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    recs = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
    return {rec["name"]: rec for rec in recs}, r.stdout


@pytest.mark.parametrize("name", list(SIZES))
def test_example_runs_without_jax(ran, name):
    rec = ran[0][name]
    assert rec["rc"] == 0 and "All Correct." in rec["out"].splitlines(), rec


def test_entry_runs_without_jax(ran):
    recs, out = ran
    assert recs["entry"]["rc"] == 0
    assert "entry() eager check on cpu (== NTTCPU; a CUDA graph needs a card): True" in out
    oks = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert len(oks) == 7, out
    assert not {"jax", "jaxlib", "gpuntt_tpu"} & set(recs["modules"]["top"])


def test_entry_without_a_card_raises():
    """The card is the default: without one the entry raises, and never
    falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(NTTDeviceError):
        E.main(["4", "reduced"])


def test_entry_step_matches_graft_entry():
    """entry()'s step on the CPU against __graft_entry__.entry()'s under
    jax.jit: the same operands and the same product."""
    sys.path.insert(0, ROOT)
    try:
        ge = importlib.import_module("__graft_entry__")
    finally:
        sys.path.remove(ROOT)
    jfn, jargs = ge.entry()
    fn, args = E.entry(CPU)
    for got, want in zip(args, jargs):
        np.testing.assert_array_equal(to_numpy_u64(got), jfrom(want, True))
    want = jfrom(jax.jit(jfn)(*jargs), True)
    np.testing.assert_array_equal(to_numpy_u64(fn(*args)), want)
    np.testing.assert_array_equal(want, E.golden())


def _compute(name):
    mod = importlib.import_module(f"gpuntt_tpu_torch.examples.{name}")
    return mod.compute(*SIZES[name], CPU)


def test_merge_examples_match_jax():
    """example_merge_ntt / _intt: the JAX scripts' draws, and what their
    checks compute through the JAX package's golden NTTCPU (unsigned,
    signed, PerCoefficient; tests/test_torch_merge.py holds the route's
    plain versions to its XLA engine)."""
    logn, batch = SIZES["example_merge_ntt"]
    p = jg.NTTParameters(logn, JMINUS, dtype=np.uint64)
    gen, q = jg.NTTCPU(p), p.modulus.value
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    mag = rng.integers(0, q // 2, size=(batch, p.n), dtype=np.uint64)
    sign = rng.integers(0, 2, size=(batch, p.n)) * 2 - 1
    x_signed = (mag.astype(np.int64) * sign).astype(np.int64)
    unsigned = np.where(x_signed < 0, x_signed + q, x_signed).astype(np.uint64)
    exp = np.stack([gen.ntt(v) for v in x])
    want = dict(x=x, x_signed=x_signed, ntt=exp,
                ntt_signed=np.stack([gen.ntt(v) for v in unsigned]), ntt_coef=exp.T)
    got = _compute("example_merge_ntt")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    exp = np.stack([gen.intt(v) for v in x])
    want = dict(x=x, intt=exp,
                intt_signed=np.where(exp > q >> 1, exp.astype(np.int64) - q,
                                     exp.astype(np.int64)),
                intt_coef=exp.T)
    got = _compute("example_merge_intt")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fourstep_examples_match_jax():
    """example_4step_ntt / _intt: the JAX scripts' draws, and the JAX
    package's golden NTT4StepCPU (tests/test_torch_fourstep.py holds
    the route to its XLA engine)."""
    logn, batch = SIZES["example_4step_ntt"]
    p = jg.NTTParameters4Step(logn, JMINUS, dtype=np.uint64)
    gen = jg.NTT4StepCPU(p)
    x = np.random.default_rng(0).integers(0, p.modulus.value, size=(batch, p.n),
                                          dtype=np.uint64)
    got = _compute("example_4step_ntt")
    np.testing.assert_array_equal(got["x"], x)
    np.testing.assert_array_equal(got["ntt"], np.stack([gen.ntt(v) for v in x]))
    got = _compute("example_4step_intt")
    np.testing.assert_array_equal(got["x"], x)
    np.testing.assert_array_equal(got["intt"], np.stack([gen.intt(v) for v in x]))


def _members(logn, count, poly):
    out = []
    for q in jg.find_ntt_primes(59, logn, count):
        om, psi = jg.ntt_root_pair(q, logn)
        out.append(jg.NTTParameters(logn, poly, dtype=np.uint64,
                                    factors=jg.NTTFactors(jg.Modulus64(q), om, psi)))
    return out


def test_rns_ntt_example_matches_jax():
    """example_rns_ntt: the JAX script's draws; each row's transform
    against the JAX package's golden NTTCPU of its modulus (what its
    per-modulus engine computes), on both schedules, and the inverses
    giving the inputs back."""
    logn, batch = SIZES["example_rns_ntt"]
    members = _members(logn, 3, JPLUS)
    qs = np.array([m.modulus.value for m in members], dtype=np.uint64)
    rng = np.random.default_rng(0)
    mod_idx = np.arange(batch) % 3
    x = np.stack([rng.integers(0, qs[mod_idx[b]], 1 << logn, dtype=np.uint64)
                  for b in range(batch)])
    sched = np.array([2, 0, 1])[np.arange(batch) % 3]
    y = np.stack([rng.integers(0, qs[sched[b]], 1 << logn, dtype=np.uint64)
                  for b in range(batch)])
    spec = np.stack([jg.NTTCPU(members[m]).ntt(v) for m, v in zip(mod_idx, x)])
    spec_o = np.stack([jg.NTTCPU(members[m]).ntt(v) for m, v in zip(sched, y)])
    want = dict(x=x, spectrum=spec, back=x, engine=spec,
                y=y, spectrum_ordered=spec_o, back_ordered=y, engine_ordered=spec_o)
    got = _compute("example_rns_ntt")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_rns_polymul_example_matches_jax():
    """example_rns_polymul: the JAX script's Z_Q operands as residue
    stacks, and each row's product through the JAX package's golden
    NTTCPU of its modulus (tests/test_torch_rns.py holds the model to
    its XLA route)."""
    logn, mod_count = SIZES["example_rns_polymul"]
    members = _members(logn, mod_count, JMINUS)
    qs = [m.modulus.value for m in members]
    big_q = 1
    for q in qs:
        big_q *= q
    rng = np.random.default_rng(0)
    a_int = [int.from_bytes(rng.bytes(16), "little") % big_q for _ in range(1 << logn)]
    b_int = [int.from_bytes(rng.bytes(16), "little") % big_q for _ in range(1 << logn)]
    a = np.stack([np.array([x % q for x in a_int], dtype=np.uint64) for q in qs])
    b = np.stack([np.array([x % q for x in b_int], dtype=np.uint64) for q in qs])
    got = _compute("example_rns_polymul")
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], b)
    want = []
    for m, u, v in zip(members, a, b):
        gen = jg.NTTCPU(m)
        want.append(gen.intt(gen.mult(gen.ntt(u), gen.ntt(v))))
    np.testing.assert_array_equal(got["product"], np.stack(want))


def test_distributed_example_matches_golden():
    """example_distributed_polymul on 4 gloo ranks (dp 2 x sp 2): the JAX
    script's operands, and the JAX package's golden NTT4StepCPU product."""
    logn, batch = SIZES["example_distributed_polymul"]
    p = jg.NTTParameters4Step(logn, JMINUS, dtype=np.uint64)
    rng = np.random.default_rng(0)
    a = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    b = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    got = _compute("example_distributed_polymul")
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], b)
    gen = jg.NTT4StepCPU(p)
    want = np.stack([gen.intt(gen.mult(gen.ntt(a[i]), gen.ntt(b[i]))) for i in range(batch)])
    np.testing.assert_array_equal(got["product"], want)
