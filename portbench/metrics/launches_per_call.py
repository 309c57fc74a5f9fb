"""launches_per_call: device operations (kernels, copies, sets) in the
traced window over the calls issued in it."""


def read(rec):
    t = rec.get("trace")
    return t["ops"] / t["calls"] if t and t["ops"] and t["calls"] else None
