"""one_pass_share: the share, in percent, of the program's ntt.launch
spans inside the calls whose `passes` attr is 1: launches whose
transforms take one pass over device memory (a whole ring on chip)
rather than two (a column and a row phase).  Read from the span registry
of gpuntt_tpu_torch (common/tracing.py), which records only under the
profiler, so only the traced slice's calls; a call is a distinct `call`
id of an ntt.entry span.  None where no ntt.entry span or no launch span
with a `passes` attr was recorded (a program whose launch spans carry no
such attr, or the plain versions on the host, which launch nothing), or
the program has no such registry."""


def of(snap):
    spans = snap["spans"]
    calls = {s["call"] for s in spans if s["name"] == "ntt.entry"}
    passes = [s["attrs"]["passes"] for s in spans
              if s["name"] == "ntt.launch" and s["call"] in calls and "passes" in s["attrs"]]
    return 100.0 * sum(p == 1 for p in passes) / len(passes) if passes else None


def read(rec):
    try:
        from gpuntt_tpu_torch.common import tracing
    except ImportError:  # a program without the span registry
        return None
    return of(tracing.snapshot())
