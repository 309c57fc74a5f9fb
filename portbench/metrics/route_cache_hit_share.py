"""route_cache_hit_share: of the cache lookups that the program's
ntt.route spans record (a plan's move to the operands' device: `plan`,
hit or move; an RNS schedule's device copy: `schedule`, hit or miss),
the share that hit, in percent.  Read from the span registry of
gpuntt_tpu_torch (common/tracing.py), which records only under the
profiler, so only the traced slice's calls.  None where no ntt.entry
span or no lookup was recorded, or the program has no such registry."""

_HIT = {"plan": "hit", "schedule": "hit"}


def of(snap):
    spans = snap["spans"]
    calls = {s["call"] for s in spans if s["name"] == "ntt.entry"}
    hits = lookups = 0
    for s in spans:
        if s["name"] != "ntt.route" or s["call"] not in calls:
            continue
        for key, hit in _HIT.items():
            if key in s["attrs"]:
                lookups += 1
                hits += s["attrs"][key] == hit
    return 100.0 * hits / lookups if lookups else None


def read(rec):
    try:
        from gpuntt_tpu_torch.common import tracing
    except ImportError:  # a program without the span registry
        return None
    return of(tracing.snapshot())
