"""entry_self_ms: mean per call of the self time of the program's
ntt.entry spans (each entry span's duration less its child spans'): the
entry's checks, allocations, reshapes and glue, neither route nor launch.
Read from the span registry of gpuntt_tpu_torch (common/tracing.py),
which records only under the profiler, so only the traced slice's calls;
a call is a distinct `call` id of an ntt.entry span.  None where no
ntt.entry span was recorded, or the program has no such registry."""


def of(snap):
    spans = snap["spans"]
    calls = {s["call"] for s in spans if s["name"] == "ntt.entry"}
    if not calls:
        return None
    ns = 0
    for s in spans:
        if s["call"] not in calls or s["end_ns"] is None:
            continue
        d = s["end_ns"] - s["start_ns"]
        if s["name"] == "ntt.entry":
            ns += d
        if s["parent"] is not None and spans[s["parent"]]["name"] == "ntt.entry":
            ns -= d
    return ns / len(calls) / 1e6


def read(rec):
    try:
        from gpuntt_tpu_torch.common import tracing
    except ImportError:  # a program without the span registry
        return None
    return of(tracing.snapshot())
