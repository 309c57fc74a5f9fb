"""setup_s: seconds from the start of the process to the first timed call:
imports, the kernels' load (or first build), plans, operand pool and
warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
