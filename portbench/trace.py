"""From a profiler trace to the intervals the per-layer metrics read.

The traced slice of a run records `torch.profiler` with CPU and CUDA
activity.  Its Chrome trace gives the device operations (kernels,
copies, sets) and the benchmark's own host spans (`record_function`
names starting with "pb."), all in microseconds on one timeline.  The
traced window runs from the start of the "pb.window" span to the later
of its end and the last device operation.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OURS = ("merge_u", "fourstep", "kmerge")  # the namespaces of the port's csrc/


def short(name: str) -> str:
    """Kernel name without its parameter list: merge_u64::rows<16, true,
    (merge_u64::RowIn)1, Stacked>, or "torch: <kernel>" for PyTorch's
    own kernels.  From the port's utils/launch_profile._short, which cuts
    at the first "(" and so loses a template argument that is an enum."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for k in range(len(name) - 1, -1, -1) if name.endswith(")") else ():
        depth += {")": 1, "(": -1}.get(name[k], 0)
        if depth == 0:
            name = name[:k].rstrip()
            break
    name = name.removeprefix("void ")
    if name.startswith(_OURS):
        return name
    return "torch: " + name.split("<")[0].split("::")[-1]


def read_chrome_trace(path: str) -> dict:
    """{"ops": [(name, start, end)], "spans": [(name, start, end)],
    "window": (start, end)} in seconds, from an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e["dur"]) * 1e-6
        if e.get("cat") in DEVICE_CATS:
            ops.append((e.get("name", "?"), t0, t1))
        elif e.get("cat") == "user_annotation" and e.get("name", "").startswith("pb."):
            spans.append((e["name"], t0, t1))
    windows = [(t0, t1) for name, t0, t1 in spans if name == "pb.window"]
    if not windows:
        raise ValueError("the trace holds no pb.window span")
    w0, w1 = windows[0]
    w1 = max([w1] + [t1 for _, t0, t1 in ops if t0 >= w0])
    return {"ops": ops, "spans": spans, "window": (w0, w1)}


def union(intervals) -> list:
    """The disjoint, sorted union of (start, end) intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [tuple(iv) for iv in out]


def summarize(trace: dict, calls: int) -> dict:
    """The window's numbers: window_s, busy_s (the union of device
    operations), op_s (their summed time), ops (their count), calls,
    device_ops (seconds by short name, the 10 largest) and idle_gaps
    (idle seconds by the host span the gap's midpoint falls in, the 10
    largest; "harness" where none)."""
    w0, w1 = trace["window"]
    ops = [(n, max(t0, w0), min(t1, w1)) for n, t0, t1 in trace["ops"] if t1 > w0 and t0 < w1]
    busy = union((t0, t1) for _, t0, t1 in ops)
    by_name: dict[str, float] = {}
    for n, t0, t1 in ops:
        by_name[short(n)] = by_name.get(short(n), 0.0) + (t1 - t0)
    gaps, last = [], w0
    for t0, t1 in busy + [(w1, w1)]:
        if t0 > last:
            gaps.append((last, t0))
        last = max(last, t1)
    spans = [s for s in trace["spans"] if s[0] != "pb.window"]
    by_span: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        label = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "harness"
        by_span[label] = by_span.get(label, 0.0) + (g1 - g0)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": w1 - w0, "busy_s": sum(t1 - t0 for t0, t1 in busy),
            "op_s": sum(t1 - t0 for _, t0, t1 in ops), "ops": len(ops), "calls": calls,
            "device_ops": top(by_name), "idle_gaps": top(by_span)}
