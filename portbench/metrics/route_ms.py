"""route_ms: mean per call of the duration of the program's ntt.route
spans: the plan's move to the operands' device, the schedule's check and
device copy, and the route decision.  Read from the span registry of
gpuntt_tpu_torch (common/tracing.py), which records only under the
profiler, so only the traced slice's calls; a call is a distinct `call`
id of an ntt.entry span.  None where no ntt.entry span was recorded, or
the program has no such registry."""


def of(snap):
    spans = snap["spans"]
    calls = {s["call"] for s in spans if s["name"] == "ntt.entry"}
    if not calls:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in spans
             if s["name"] == "ntt.route" and s["call"] in calls and s["end_ns"] is not None)
    return ns / len(calls) / 1e6


def read(rec):
    try:
        from gpuntt_tpu_torch.common import tracing
    except ImportError:  # a program without the span registry
        return None
    return of(tracing.snapshot())
