"""The port's counters and spans, in one registry.

Counters are always on:

- each kernel's `KernelStats`, which registers itself here: `launches`
  (every launch through ops/kernel.launch) and `plain_calls` (every
  plain-version call through the kernel's wrapper, ops/kernel.call);
- `COUNTERS`, plain integers: `plan_to.hit` / `plan_to.move` (a plan's
  `.to(device)` in MergePlan, RNSMergePlan and FourStepPlan returned
  the plan or a cached copy / built a copy), `schedule.hit` /
  `schedule.miss` (ops/rns.schedule_memo, the memo of the RNS entries'
  routes, ops/dispatch._rns_route, and of the RNS 4-step's schedule
  copies, found what an earlier call derived from the schedule / derived
  it).

Spans are recorded only while a torch.profiler session records
(`recording()`, one read of the profiler's enabled flag).  A span then
enters `torch.profiler.record_function(name)`, so that it lands in the
profiler's trace beside the kernels, and appends a record to a list
here: its name, `start_ns` and `end_ns` read with time.time_ns() inside
the record_function (the clock of the exported Chrome trace, whose
events start at `ts` * 1000 + `baseTimeNanoseconds`), `parent` (the
index of the enclosing span), `call` (a sequence number shared by every
span under one outermost span) and a small `attrs` dict.  While nothing
records, a span site reads the flag and does nothing more.

    ntt.entry   a lanes entry of ops/dispatch.py or ops/fourstep.py, the
                whole call (attrs: entry); an entry that calls another
                holds the other's span
    ntt.route   inside an entry: the plan's move to the operand's device,
                the schedule's check and device copy, the route decision
                (attrs: path; plan, hit or move; schedule, hit or miss:
                whether the RNS route memo held the route; lanes, the RNS
                operand's dtype, "int32" or "int64"; on the big-ring
                route "hopper-merge-large" passes, the passes over device
                memory the transform takes, LargePlan.passes, which is
                also its launches: 2 at logn 18-22, 3 at 23-28)
    ntt.launch  ops/kernel.launch, the one function every C entry
                passes through: the stream lookup, the call and its
                return code (attrs: kernel; word, the bytes of the
                operand's words in device memory, 4 or 8; on the
                merge_u32.cu entries passes, the passes over device
                memory a transform of the launch takes, 1 or 2)

An entry's self time, its duration less its children's, is the work
that is neither route nor launch: the wrappers' checks, allocations,
reshapes and glue.  `snapshot()` gives the spans and the counters,
`reset()` zeroes the counters and drops the spans.  Spans nest on one
stack: record them from one thread at a time.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _profiler

ENTRY, ROUTE, LAUNCH = "ntt.entry", "ntt.route", "ntt.launch"


@dataclass
class KernelStats:
    """What a kernel replaces, and how often it ran since the last reset."""

    name: str
    replaces: str
    route: str = "cuda"
    source: str = ""
    launches: int = 0
    plain_calls: int = 0

    def __post_init__(self):
        _KERNELS.append(self)


_KERNELS: list[KernelStats] = []
COUNTERS = dict.fromkeys(("plan_to.hit", "plan_to.move", "schedule.hit", "schedule.miss"), 0)
_spans: list["_Span"] = []  # every span recorded since the last reset
_open: list["_Span"] = []  # the spans entered and not yet left, outermost first
_calls = [0]  # the next outermost span's `call`


def recording() -> bool:
    """Whether a torch.profiler session records now: the one read that
    decides whether a span site keeps its span."""
    return _profiler._is_profiler_enabled


class _Span:
    """A span, open from its making to its end()."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "call", "index", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self._fn = torch.profiler.record_function(name)
        self._fn.__enter__()
        if _open:
            self.parent, self.call = _open[-1].index, _open[-1].call
        else:
            self.parent, self.call = None, _calls[0]
            _calls[0] += 1
        self.index = len(_spans)
        self.end_ns = None
        _spans.append(self)
        _open.append(self)
        self.start_ns = time.time_ns()

    def end(self) -> None:
        self.end_ns = time.time_ns()
        if _open and _open[-1] is self:
            _open.pop()
        self._fn.__exit__(None, None, None)


def begin(name: str, key: str | None = None, value=None) -> _Span | None:
    """The span `name`, opened now with attrs {key: value} where `key` is
    given, while recording; None otherwise.  A site closes it in a
    `finally`, `if span: span.end()`: off, the site costs the flag read,
    the call and that test (a `with` block would cost two calls more)."""
    if not recording():
        return None
    return _Span(name, {} if key is None else {key: value})


def entry(fn):
    """`fn` under an ntt.entry span, attrs {"entry": its name}, while
    recording."""
    name = fn.__name__

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not recording():
            return fn(*args, **kwargs)
        span = _Span(ENTRY, {"entry": name})
        try:
            return fn(*args, **kwargs)
        finally:
            span.end()

    return traced


def outcome(counter: str, attr: str, value: str) -> None:
    """Count a cache lookup's outcome under COUNTERS[counter] and, where
    the innermost open span is an ntt.route span, note attr=value on it
    unless an earlier lookup of the span already did (a plan's move
    moves its members too: the span keeps the outermost outcome)."""
    COUNTERS[counter] += 1
    if _open and _open[-1].name == ROUTE:
        _open[-1].attrs.setdefault(attr, value)


def reset() -> None:
    """Zero every counter, kernels' included, and drop the recorded spans
    (a span still open is dropped with them)."""
    for k in _KERNELS:
        k.launches = k.plain_calls = 0
    for key in COUNTERS:
        COUNTERS[key] = 0
    _spans.clear()
    _open.clear()
    _calls[0] = 0


def snapshot() -> dict:
    """{"spans": [{"name", "start_ns", "end_ns", "parent", "call",
    "attrs"}, ...] (end_ns None for a span still open), "counters":
    COUNTERS' values, "kernels": {name: {"launches", "plain_calls"}}},
    copies of what the registry holds now."""
    return {
        "spans": [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                   "parent": s.parent, "call": s.call, "attrs": dict(s.attrs)} for s in _spans],
        "counters": dict(COUNTERS),
        "kernels": {k.name: {"launches": k.launches, "plain_calls": k.plain_calls}
                    for k in _KERNELS},
    }


def split_ms(spans: list) -> dict:
    """Milliseconds a call, over the calls that hold an ntt.entry span,
    of the entries' self time ("entry_self"), the ntt.route spans
    ("route") and the ntt.launch spans ("launch"), and the number of
    those calls ("calls"); the three add up to the mean outermost entry.
    Every span must be closed."""
    calls = {s["call"] for s in spans if s["name"] == ENTRY}
    dur = [s["end_ns"] - s["start_ns"] for s in spans]
    self_ns = {ENTRY: 0, ROUTE: 0, LAUNCH: 0}
    for s, d in zip(spans, dur):
        if s["call"] in calls and s["name"] in self_ns:
            self_ns[s["name"]] += d
    for s, d in zip(spans, dur):  # an entry's children leave its self time
        if s["call"] in calls and s["parent"] is not None and spans[s["parent"]]["name"] == ENTRY:
            self_ns[ENTRY] -= d
    n = max(len(calls), 1)
    return {"calls": len(calls), "entry_self": self_ns[ENTRY] / n / 1e6,
            "route": self_ns[ROUTE] / n / 1e6, "launch": self_ns[LAUNCH] / n / 1e6}
