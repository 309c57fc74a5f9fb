"""The two closed loops that drive an entry, and the sample they keep.

`stream`: calls issued back to back with at most `in_flight` in flight
(before issuing call i the caller waits on call i - in_flight's
completion event); the window runs from the first call's issue to the
last call's completion.  `sync`: one call at a time, each waited on with
a device synchronisation before the next is issued; each call's latency
is read between two CUDA events recorded before the call and after it.

Both stop issuing once `seconds` have passed or `max_calls` calls have
been issued, whichever is set and comes first.  `span(name)` wraps the
entry call ("pb.entry") and the waits ("pb.wait", "pb.sync"): a
profiler's record_function in the traced slice, nothing otherwise.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time
import traceback
from collections import deque

import torch


class _HostEvent:
    """Stands in for a CUDA event where the operands lie on the host, whose
    operations finish before they return (the CPU tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Device:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def event(self, timing: bool = True):
        """A CUDA event, with a timestamp only where `timing`.  An event
        that is only waited on takes none: on an H100 a timestamp after
        every call slowed streams of 0.27-0.48 ms calls by 0.2-0.5%."""
        return torch.cuda.Event(enable_timing=timing) if self.cuda else _HostEvent()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


class Sample:
    """A reservoir of `k` call outputs, uniform over the calls offered,
    drawn with the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (i, out)


def _none(_name):
    return contextlib.nullcontext()


class _Calls:
    """Issues calls, counts those that raise, and sums the host time each
    call takes to return."""

    def __init__(self, call, first, sample):
        self.call, self.i, self.sample = call, first, sample
        self.n = self.failed = 0
        self.enqueue_s = 0.0

    def issue(self, span):
        t = time.perf_counter()
        try:
            with span("pb.entry"):
                out = self.call(self.i)
        except Exception:  # a failed call counts against the run, which goes on
            if not self.failed:
                traceback.print_exc(file=sys.stderr)
            self.failed += 1
            out = None
        self.enqueue_s += time.perf_counter() - t
        if out is not None:
            self.sample.offer(self.i, out)
        self.i += 1
        self.n += 1
        return out is not None

    def done(self, max_calls, stop) -> bool:
        return (max_calls is not None and self.n >= max_calls) or (
            stop is not None and time.perf_counter() >= stop)

    def record(self, t0) -> dict:
        return {"calls": self.n, "failed": self.failed, "window_s": time.perf_counter() - t0,
                "enqueue_s": self.enqueue_s}


def stream(call, first, dev, sample, in_flight, seconds=None, max_calls=None, span=_none):
    calls, ring = _Calls(call, first, sample), deque()
    t0 = time.perf_counter()
    stop = None if seconds is None else t0 + seconds
    while True:
        if len(ring) >= in_flight:
            with span("pb.wait"):
                ring.popleft().synchronize()
        calls.issue(span)
        ev = dev.event(timing=False)
        ev.record()
        ring.append(ev)
        if calls.done(max_calls, stop):
            break
    with span("pb.wait"):
        dev.sync()
    return calls.record(t0)


def sync(call, first, dev, sample, seconds=None, max_calls=None, span=_none):
    calls, latencies = _Calls(call, first, sample), []
    start, end = dev.event(), dev.event()
    t0 = time.perf_counter()
    stop = None if seconds is None else t0 + seconds
    while True:
        start.record()
        ok = calls.issue(span)
        end.record()
        with span("pb.sync"):
            dev.sync()
        latencies.append(start.elapsed_time(end) if ok else float("inf"))
        if calls.done(max_calls, stop):
            break
    rec = calls.record(t0)
    rec["latencies_ms"] = latencies
    return rec


LOOPS = {"stream": stream, "sync": sync}
