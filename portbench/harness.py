"""Runs one cell once: set-up, the measured window, the traced slice, the
check against the reference, and the result.

Everything a cell needs is found by name.  BENCHMARK.json (at the root
of the checkout) maps the cell to its configuration and traffic;
configs/<config>.json holds the sizes, traffic/<traffic>.json the loop
and its parameters, entries/<entry>.py (named by the traffic) how to
build the program's plans, draw the operand pool, call the program and
call the reference, and metrics/<metric>.py how each metric is read from
the run's record.  A later cell, entry or metric is new files and new
entries in BENCHMARK.json.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

from . import loops, trace
from .reference import modpoly

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _named(kind: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return HERE / kind / f"{name}{suffix}"


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    return json.loads(_named("configs", name, ".json").read_text())


def traffic(name: str) -> dict:
    return json.loads(_named("traffic", name, ".json").read_text())


def module(kind: str, name: str):
    """entries/<name>.py or metrics/<name>.py, loaded from its file (a
    metric's name may hold dots)."""
    path = _named(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_spec(name: str) -> dict:
    """The cell's "config", "traffic" and "entry" adapter, found by name."""
    w = cell(benchmark(), name)
    tr = traffic(w["traffic"])
    return {"config": config(w["config"]), "traffic": tr, "entry": module("entries", tr["entry"])}


def metrics_of(bench: dict, name: str, trace_run: bool) -> list:
    """The cell's end-to-end metrics (trace_run False) or per-layer ones."""
    kind = "per_layer" if trace_run else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def _traced(run_loop, dev: loops.Device) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("pb.window"):
            rec = run_loop(torch.profiler.record_function)
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        rec["trace"] = trace.summarize(trace.read_chrome_trace(path), rec["calls"])
    finally:
        os.remove(path)
    return rec


def execute(name: str, seed: int, seconds: float, trace_run: bool, device,
            t_start: float, spec: dict | None = None) -> dict:
    """One run of cell `name`.  `spec` (cell_spec's keys) may stand in for
    what is found by name, as in the tests and the control.  Returns the
    run's record: the result's numbers, the check's numbers and the
    metric readers' inputs."""
    spec = spec or cell_spec(name)
    cfg, tr, entry = spec["config"], spec["traffic"], spec["entry"]
    device = torch.device(device)
    dev = loops.Device(device)

    if dev.cuda:  # load the port's kernels, building those not yet built (first run)
        from gpuntt_tpu_torch.ops import _build
        _build.build_all()
    state = entry.build(cfg, tr, device)
    pool = entry.operands_pool(cfg, tr, seed, device)
    for i in range(tr["warmup_calls"]):
        entry.call(state, pool, i)
    dev.sync()
    setup_s = time.perf_counter() - t_start

    sample = loops.Sample(tr["sample_calls"], seed)
    loop = loops.LOOPS[tr["loop"]]
    kw = {"in_flight": tr["in_flight"]} if tr["loop"] == "stream" else {}
    call = lambda i: entry.call(state, pool, i)  # noqa: E731
    rec = loop(call, 0, dev, sample, seconds=seconds, **kw)
    if trace_run:
        traced = _traced(lambda span: loop(call, rec["calls"], dev, sample,
                                           max_calls=tr["trace_calls"], span=span, **kw), dev)
        rec["trace"] = traced["trace"]
        rec["attempted"] = rec["calls"] + traced["calls"]
        rec["failed"] += traced["failed"]
    else:
        rec["attempted"] = rec["calls"]
    rec["setup_s"] = setup_s
    rec.update(entry.counts(cfg, tr))
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if dev.cuda else 0

    # the check: the program's state goes first; the reference draws the
    # operands again from the seed and judges each kept output
    del state, pool, call
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    pool = entry.operands_pool(cfg, tr, seed, device)
    mismatched = 0
    for i, out in sample.kept:
        want = entry.reference(cfg, tr, pool, i, modpoly.mulmod)
        if out.shape != want.shape or out.dtype != want.dtype:
            mismatched += want.numel()
        else:
            mismatched += int((out != want).sum())
    rec["check_s"] = time.perf_counter() - t
    rec["check"] = {
        "mismatched_coefs": {"value": mismatched, "max": 0},
        "failed_calls": {"value": rec["failed"], "max": 0},
        "compared_calls": {"value": len(sample.kept), "min": 1},
    }
    rec["correct"] = mismatched == 0 and rec["failed"] == 0 and len(sample.kept) >= 1
    return rec
