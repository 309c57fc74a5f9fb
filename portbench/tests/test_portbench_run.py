"""Whole runs at a size the CPU holds (tests/tiny.py): a sound run is
correct; the control and each fault the cells can have make `correct`
false.  The harness's look for a card is skipped by calling
harness.execute on the CPU; the command line itself refuses a machine
without a card, and loads neither JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness
from portbench.control import Control
from portbench.tests import tiny

ROOT = harness.ROOT
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SEED = 2**31 + 11


def _run(name, spec, trace_run=False):
    return harness.execute(name, SEED, 0.2, trace_run, "cpu", time.perf_counter(), spec=spec)


def _broken(spec, fault):
    """`spec` with its entry's call replaced by fault(out, operands)."""
    entry = spec["entry"]
    bad = types.SimpleNamespace(**{k: getattr(entry, k) for k in
                                   ("counts", "operands_pool", "build", "reference")})
    bad.call = lambda state, pool, i: fault(entry.call(state, pool, i), pool[i % len(pool)])
    return dict(spec, entry=bad)


@pytest.mark.parametrize("trace_run", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, trace_run):
    rec = _run(name, tiny.spec(name), trace_run)
    assert rec["correct"], rec["check"]
    assert rec["check"]["compared_calls"]["value"] == min(3, rec["attempted"])
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    if trace_run:
        assert rec["trace"]["calls"] == 4


def _first(ops):
    return ops[0] if isinstance(ops, tuple) else ops


def _half_rows(out, ops):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _altered(out, ops):
    out = out.clone()
    out.view(-1)[7] += 1
    return out


FAULTS = {
    "state_unchanged": lambda out, ops: _first(ops).clone(),
    "answer_altered": _altered,
    "half_batch": _half_rows,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_in_the_timed_path_is_not_correct(name, fault):
    spec = tiny.spec(name)
    if fault == "half_batch" and spec["entry"].counts(spec["config"], spec["traffic"])[
            "coefs"] >> spec["config"]["logn"] < 2:
        pytest.skip("one row a call: no half of the batch to leave out")
    rec = _run(name, _broken(spec, FAULTS[fault]))
    assert not rec["correct"]
    assert rec["check"]["mismatched_coefs"]["value"] > 0


def test_a_call_that_raises_is_counted_failed():
    spec = tiny.spec(CELLS[0])
    warm = iter(range(spec["traffic"]["warmup_calls"]))

    def fault(out, ops):  # the warm-up passes, every call of the window raises
        if next(warm, None) is None:
            raise RuntimeError("refused")
        return out

    rec = _run(CELLS[0], _broken(spec, fault))
    assert not rec["correct"] and rec["failed"] == rec["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_program_place_is_not_correct(name):
    spec = tiny.spec(name)
    rec = _run(name, dict(spec, entry=Control(spec["entry"], spec["config"], spec["traffic"])))
    assert not rec["correct"]
    assert rec["check"]["mismatched_coefs"]["value"] > 0


def _cli(*args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_machine_without_a_card_gets_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _cli("--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0",
             env=env)
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA card" in r.stderr


def test_the_harness_loads_no_jax():
    code = ("import sys, portbench.run as run, portbench.control\n"
            "from portbench import harness\n"
            "b = harness.benchmark()\n"
            "[harness.module('entries', harness.traffic(w['traffic'])['entry']) "
            "for w in b['workloads']]\n"
            "[harness.module('metrics', m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
            "import gpuntt_tpu_torch\n"
            "print(run.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_forbidden_names_compare_the_top_level_whole():
    from portbench import run

    names = ["gpuntt_tpu_torch", "gpuntt_tpu_torch.ops", "jaxtyping", "gpuntt_tpu.ops.x",
             "jax", "jaxlib.xla", "flax.linen", "gpuntt_tpu"]
    assert run.forbidden_modules(names) == ["flax.linen", "gpuntt_tpu", "gpuntt_tpu.ops.x",
                                            "jax", "jaxlib.xla"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace_run", ["0", "1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name, trace_run):
    r = _cli("--workload", name, "--seed", str(SEED), "--seconds", "1", "--trace", trace_run)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert ("breakdown" in out) == (trace_run == "1")
