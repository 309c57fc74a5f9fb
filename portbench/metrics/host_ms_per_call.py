"""host_ms_per_call: mean host time for an entry call to return (the
enqueue, no synchronisation), over every call of the untraced window."""


def read(rec):
    return rec["enqueue_s"] / rec["calls"] * 1e3 if rec["calls"] else None
