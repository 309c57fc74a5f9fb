"""The port's span and counter registry (gpuntt_tpu_torch/common/tracing.py)
and the benchmark's four readers of it, on the CPU.

Spans are recorded only under torch.profiler, each inside a
record_function twin on the profiler's clock; counters always count; the
entries of ops/dispatch.py and ops/fourstep.py nest their ntt.entry,
ntt.route and ntt.launch spans as the registry documents; and the
readers entry_self_ms, route_ms, launch_ms and route_cache_hit_share
read a snapshot, a hand-built one and one of a traced benchmark run at
a size the CPU holds.  Imports no jax.
"""

import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import kernel
from gpuntt_tpu_torch.ops.limb import from_numpy_u64

from portbench import harness
from portbench.tests import tiny

LOGN = 12
READERS = ("entry_self_ms", "route_ms", "launch_ms", "route_cache_hit_share")
SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def _clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _rns_plan(device="cpu"):
    ms = []
    for q in tg.find_ntt_primes(59, LOGN, 3):
        om, psi = tg.ntt_root_pair(q, LOGN)
        ms.append(tg.NTTParameters(LOGN, tg.ReductionPolynomial.X_N_plus, np.uint64,
                                   factors=tg.NTTFactors(tg.Modulus64(q), om, psi)))
    return tg.RNSMergePlan.from_params(ms, device=device)


def _rns_operands(plan):
    rng = np.random.default_rng(0)
    return [from_numpy_u64(rng.integers(0, min(plan.qs), size=(3, plan.n),
                                        dtype=np.uint64), "cpu") for _ in range(2)]


def _merge_plan():
    p = tg.NTTParameters(LOGN, tg.ReductionPolynomial.X_N_plus, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    rng = np.random.default_rng(1)
    a, b = (from_numpy_u64(rng.integers(0, p.modulus.value, size=(2, p.n), dtype=np.uint64),
                           "cpu") for _ in range(2))
    return plan, a, b


def _profiled(fn, *args, **kwargs):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kwargs)
    return out, prof


def test_no_span_while_the_profiler_is_off_and_counters_count():
    plan = _rns_plan()
    a, b = _rns_operands(plan)
    sched = np.arange(3) % 3
    td.rns_polymul_lanes(a, b, plan, sched)
    td.rns_polymul_lanes(a, b, plan, sched)
    snap = tracing.snapshot()
    assert snap["spans"] == []
    assert snap["counters"] == {"plan_to.hit": 2, "plan_to.move": 0, "schedule.hit": 1,
                                "schedule.miss": 1}
    assert snap["kernels"][hr.FORWARD.name] == {"launches": 0, "plain_calls": 4}
    assert snap["kernels"][hr.POLYMUL_INVERSE.name] == {"launches": 0, "plain_calls": 2}
    tracing.reset()
    assert hr.FORWARD.plain_calls == 0 and set(tracing.snapshot()["counters"].values()) == {0}


def test_recording_reads_the_profilers_flag():
    """The flag tracing.recording() reads must follow a torch.profiler
    session: a torch that moves it fails here."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert not tracing.recording()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.recording()
    assert not tracing.recording()


def test_each_span_lies_within_its_record_function_twin(tmp_path):
    plan, a, b = _merge_plan()
    _, prof = _profiled(tg.polymul_lanes, a, b, plan)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    twins: dict[str, list] = {}
    for e in sorted(trace["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                e["name"].startswith("ntt."):
            twins.setdefault(e["name"], []).append(e)
    spans = tracing.snapshot()["spans"]
    assert Counter(s["name"] for s in spans) == {n: len(v) for n, v in twins.items()}
    seen = Counter()
    for s in spans:  # recorded in order of their start, as the twins sort
        e = twins[s["name"]][seen[s["name"]]]
        seen[s["name"]] += 1
        t0 = float(e["ts"]) * 1000 + base
        t1 = (float(e["ts"]) + float(e["dur"])) * 1000 + base
        assert t0 <= s["start_ns"] + 1000 and s["end_ns"] <= t1 + 1000, (s, e)
        assert s["start_ns"] <= s["end_ns"]


def test_nested_polymul_links_parents_shares_calls_and_splits_self_time():
    plan, a, b = _merge_plan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        want = tg.polymul_lanes(a, b, plan)
        tg.polymul_lanes(a, b, plan)
    spans = tracing.snapshot()["spans"]
    names = [(s["name"], s["attrs"].get("entry")) for s in spans]
    one = [("ntt.entry", "polymul_lanes"), ("ntt.route", None), ("ntt.entry", "ntt_lanes"),
           ("ntt.route", None), ("ntt.entry", "ntt_lanes"), ("ntt.route", None)]
    assert names == one + one
    assert [s["parent"] for s in spans] == [None, 0, 0, 2, 0, 4, None, 6, 6, 8, 6, 10]
    assert [s["call"] for s in spans] == [0] * 6 + [1] * 6
    assert spans[1]["attrs"] == {"plan": "hit", "path": "hopper-merge"}
    assert all(s["name"].startswith("ntt.") for s in spans)
    for s in spans:
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    outer = [s["end_ns"] - s["start_ns"] for s in spans if s["parent"] is None]
    children = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["parent"] is not None and spans[s["parent"]]["name"] == "ntt.entry")
    entries = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == "ntt.entry")
    routes = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == "ntt.route")
    split = tracing.split_ms(spans)
    assert split["calls"] == 2 and split["launch"] == 0
    assert split["entry_self"] == pytest.approx((entries - children) / 2e6)
    assert split["route"] == pytest.approx(routes / 2e6)
    assert split["entry_self"] + split["route"] == pytest.approx(sum(outer) / 2e6)
    assert torch.equal(tg.polymul_lanes(a, b, plan), want)


def _route_attrs(fn, *args):
    tracing.reset()
    _profiled(fn, *args)
    return [s["attrs"] for s in tracing.snapshot()["spans"] if s["name"] == "ntt.route"]


def test_plan_and_schedule_outcomes_first_call_repeat_and_a_new_schedule():
    """A plan built for "cpu:0" moves once to the operands' "cpu" and is
    found there after; a schedule is copied once and found after."""
    plan = _rns_plan(device="cpu:0")
    a, b = _rns_operands(plan)
    first = _route_attrs(td.rns_polymul_lanes, a, b, plan, np.arange(3) % 3)
    assert first == [{"plan": "move", "schedule": "miss", "path": "hopper-rns",
                    "lanes": "int64"}]
    assert tracing.COUNTERS["plan_to.move"] == 1 and tracing.COUNTERS["schedule.miss"] == 1
    again = _route_attrs(td.rns_polymul_lanes, a, b, plan, np.arange(3) % 3)
    assert again == [{"plan": "hit", "schedule": "hit", "path": "hopper-rns",
                    "lanes": "int64"}]
    assert tracing.COUNTERS["plan_to.hit"] == 1 and tracing.COUNTERS["schedule.hit"] == 1
    new = _route_attrs(td.ntt_rns_lanes, a, plan, np.array([2, 0, 1]))
    assert new == [{"plan": "hit", "schedule": "miss", "path": "hopper-rns",
                  "lanes": "int64"}]
    p = tg.NTTParameters(LOGN, tg.ReductionPolynomial.X_N_plus, np.uint64)
    merge = tg.MergePlan.from_params(p, device="cpu:0")
    x = a[:1].contiguous()
    assert _route_attrs(tg.ntt_lanes, x, merge) == [{"plan": "move", "path": "hopper-merge"}]
    assert _route_attrs(tg.ntt_lanes, x, merge) == [{"plan": "hit", "path": "hopper-merge"}]


class _Stream:
    cuda_stream = 0


def test_launch_span_comes_from_launch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    x = torch.zeros(4, dtype=torch.int64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        kernel.launch(hm.FORWARD, fn, x, 1, 2)
        with pytest.raises(tg.NTTDeviceError):
            kernel.launch(hm.INVERSE, lambda *args: 700, x)
    spans = tracing.snapshot()["spans"]
    assert [(s["name"], s["attrs"], s["parent"]) for s in spans] == [
        ("ntt.launch", {"kernel": hm.FORWARD.name, "word": 8}, None),
        ("ntt.launch", {"kernel": hm.INVERSE.name, "word": 8}, None)]
    assert all(s["end_ns"] is not None for s in spans)
    assert len(calls) == 1 and calls[0][1:3] == (1, 2)
    assert (hm.FORWARD.launches, hm.INVERSE.launches) == (1, 0)


def _span(name, t0, t1, parent, call, **attrs):
    return {"name": name, "start_ns": t0, "end_ns": t1, "parent": parent, "call": call,
            "attrs": attrs}


def test_readers_on_a_hand_built_snapshot():
    ms = 1_000_000
    spans = [
        # call 0: an entry of 10 ms holding a route of 1 ms and launches of 2 and 3 ms
        _span("ntt.entry", 0, 10 * ms, None, 0, entry="rns_polymul_lanes"),
        _span("ntt.route", 1 * ms, 2 * ms, 0, 0, plan="hit", schedule="miss", path="x"),
        _span("ntt.launch", 3 * ms, 5 * ms, 0, 0, kernel="k"),
        _span("ntt.launch", 6 * ms, 9 * ms, 0, 0, kernel="k"),
        # call 1: an entry of 20 ms holding a route of 2 ms and a nested entry of 10 ms,
        # which holds a route of 1 ms and a launch of 4 ms
        _span("ntt.entry", 20 * ms, 40 * ms, None, 1, entry="polymul_lanes"),
        _span("ntt.route", 21 * ms, 23 * ms, 4, 1, plan="hit", path="y"),
        _span("ntt.entry", 25 * ms, 35 * ms, 4, 1, entry="ntt_lanes"),
        _span("ntt.route", 26 * ms, 27 * ms, 6, 1, plan="move", path="y"),
        _span("ntt.launch", 28 * ms, 32 * ms, 6, 1, kernel="k"),
        # a launch outside any entry is no call's
        _span("ntt.launch", 50 * ms, 90 * ms, None, 2, kernel="k"),
    ]
    snap = {"spans": spans, "counters": {}, "kernels": {}}
    got = {name: harness.module("metrics", name).of(snap) for name in READERS}
    # self: call 0 10 - 1 - 2 - 3 = 4; call 1 (20 - 2 - 10) + (10 - 1 - 4) = 13
    assert got["entry_self_ms"] == pytest.approx((4 + 13) / 2)
    assert got["route_ms"] == pytest.approx((1 + 2 + 1) / 2)
    assert got["launch_ms"] == pytest.approx((2 + 3 + 4) / 2)
    assert got["route_cache_hit_share"] == pytest.approx(100 * 2 / 4)
    assert sum(got[m] for m in READERS[:3]) == pytest.approx((10 + 20) / 2)
    split = tracing.split_ms(spans)
    assert (split["entry_self"], split["route"], split["launch"]) == pytest.approx(
        (got["entry_self_ms"], got["route_ms"], got["launch_ms"]))
    empty = {"spans": spans[-1:], "counters": {}, "kernels": {}}
    assert all(harness.module("metrics", name).of(empty) is None for name in READERS)


def _traced_run(name):
    spec = tiny.spec(name)
    rec = harness.execute(name, SEED, 0.05, True, "cpu", time.perf_counter(), spec=spec)
    assert rec["correct"], rec["check"]
    return rec


def test_readers_after_a_traced_run_of_the_single_cell():
    name = "he_n15_polymul_single"
    rec = _traced_run(name)
    got = {m: harness.module("metrics", m).read(rec) for m in READERS}
    assert all(v is not None and np.isfinite(v) for v in got.values()), got
    assert got["launch_ms"] == 0  # the plain versions launch nothing
    assert got["route_cache_hit_share"] == 100
    spans = tracing.snapshot()["spans"]
    outer = [s["end_ns"] - s["start_ns"] for s in spans if s["parent"] is None]
    assert len(outer) == rec["trace"]["calls"]
    assert sum(got[m] for m in READERS[:3]) == pytest.approx(np.mean(outer) / 1e6)
    assert {m["name"] for m in harness.metrics_of(harness.benchmark(), name, True)} >= set(READERS)


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark()["workloads"]])
def test_each_cells_entry_records_entry_and_route_spans_when_traced(name):
    rec = _traced_run(name)
    spans = tracing.snapshot()["spans"]
    top = [s for s in spans if s["parent"] is None]
    assert len(top) == rec["trace"]["calls"]
    assert all(s["name"] == "ntt.entry" for s in top)
    assert any(s["name"] == "ntt.route" for s in spans)
    assert all(s["name"].startswith("ntt.") for s in spans)
