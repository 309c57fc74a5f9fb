"""Cells cut to a size the CPU runs in a second: the same entries, loops
and checks as the benchmark's cells, at logn 12 with few rows."""

from __future__ import annotations

from portbench import harness
from portbench.reference import primes

LOGN = 12


def spec(cell_name: str) -> dict:
    """config, traffic and entry of `cell_name`, cut down: logn 12, two
    primes for an RNS ladder, one ciphertext a call, small pools."""
    spec = harness.cell_spec(cell_name)
    cfg, tr = spec["config"], spec["traffic"]
    cfg["logn"] = LOGN
    if "primes" in cfg:
        cfg["primes"] = primes.ntt_primes(cfg["prime_bits"], LOGN, 2)
    else:
        cfg["q"] = primes.ntt_primes(cfg["prime_bits"], LOGN, 1)[0]
        cfg["fourstep_dims"] = [32, 128]  # GPU-NTT's split of 2^12
    if "ciphertexts_per_call" in tr:
        tr["ciphertexts_per_call"] = 1
    tr.update(pool_calls=3, warmup_calls=2, sample_calls=3, trace_calls=4)
    return spec
