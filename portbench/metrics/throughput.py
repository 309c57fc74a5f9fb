"""throughput: output coefficients of every call completed in the window,
over the window's time (first issue to last completion, host clock), in
millions a second.  Read in closed-loop streams only."""


def read(rec):
    if "latencies_ms" in rec or not rec["window_s"]:
        return None
    return rec["calls"] * rec["coefs"] / rec["window_s"] / 1e6
