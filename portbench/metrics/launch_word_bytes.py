"""launch_word_bytes: the mean `word` attr of the program's ntt.launch
spans inside the calls: the bytes of each word the launched kernels read
and write in device memory (4 for int32 lanes, 8 for int64 ones).  Read
from the span registry of gpuntt_tpu_torch (common/tracing.py), which
records only under the profiler, so only the traced slice's calls; a
call is a distinct `call` id of an ntt.entry span.  None where no
ntt.entry span or no launch span with a `word` attr was recorded (the
plain versions on the host launch nothing), or the program has no such
registry."""


def of(snap):
    spans = snap["spans"]
    calls = {s["call"] for s in spans if s["name"] == "ntt.entry"}
    words = [s["attrs"]["word"] for s in spans
             if s["name"] == "ntt.launch" and s["call"] in calls and "word" in s["attrs"]]
    return sum(words) / len(words) if words else None


def read(rec):
    try:
        from gpuntt_tpu_torch.common import tracing
    except ImportError:  # a program without the span registry
        return None
    return of(tracing.snapshot())
