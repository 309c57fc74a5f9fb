"""RNS (multi-modulus) NTT example — no reference counterpart.

The reference's RNS overloads exist but its examples only exercise
mod_count = 1 (test_merge_ntt.cu:143-144); this script demonstrates the
real thing: a batch cycling through three 59-bit NTT primes, forward
and inverse, plus an explicit GPU_NTT_Modulus_Ordered-style schedule,
each against the per-modulus engine (ops/rns.rns_ntt_lanes).  On the
card, rings of 2^12-2^17 run the whole schedule as one kernel, K12
(csrc/merge_u64.cu rns_u64_forward / rns_u64_inverse), whose blocks
read their ring's modulus from the schedule.

Usage: python -m gpuntt_tpu_torch.examples.example_rns_ntt [RING_SIZE_IN_LOG2] [BATCH] [--device=cuda|cpu]
Prints "All Correct." on success (check_result, common.cu:24-42).
"""

from __future__ import annotations

import sys

import numpy as np

from .. import (Modulus64, NTTFactors, NTTParameters, ReductionPolynomial, check_result,
                find_ntt_primes, intt_modulus_ordered, intt_rns, ntt_modulus_ordered,
                ntt_root_pair, ntt_rns)
from ..ops.merge_ntt import from_lanes, to_lanes
from ..ops.rns import RNSMergePlan, rns_ntt_lanes
from . import _device

ORDER = np.array([2, 0, 1], dtype=np.int64)


def rns_members(logn: int, count: int) -> list[NTTParameters]:
    """`count` distinct 59-bit NTT-friendly primes with their 2N-th roots."""
    out = []
    for q in find_ntt_primes(59, logn, count):
        om, psi = ntt_root_pair(q, logn)
        out.append(NTTParameters(logn, ReductionPolynomial.X_N_plus, dtype=np.uint64,
                                 factors=NTTFactors(Modulus64(q), om, psi)))
    return out


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """Both schedules' inputs, transforms, engine transforms and inverses."""
    plan = RNSMergePlan.from_params(rns_members(logn, 3), device=device)
    qs = np.array(plan.qs, dtype=np.uint64)
    rng = np.random.default_rng(0)

    # cyclic schedule (GPU_NTT RNS overload semantics)
    mod_idx = np.arange(batch) % plan.mod_count
    x = np.stack([rng.integers(0, qs[mod_idx[b]], 1 << logn, dtype=np.uint64)
                  for b in range(batch)])
    spectrum = ntt_rns(x, plan)
    out = dict(x=x, spectrum=spectrum, back=intt_rns(spectrum, plan),
               engine=from_lanes(rns_ntt_lanes(to_lanes(x, True, device), plan, mod_idx),
                                 True))

    # explicit modulus schedule (GPU_NTT_Modulus_Ordered semantics)
    sched = ORDER[np.arange(batch) % len(ORDER)]
    y = np.stack([rng.integers(0, qs[sched[b]], 1 << logn, dtype=np.uint64)
                  for b in range(batch)])
    spec_o = ntt_modulus_ordered(y, plan, ORDER)
    out.update(y=y, spectrum_ordered=spec_o, back_ordered=intt_modulus_ordered(spec_o, plan, ORDER),
               engine_ordered=from_lanes(rns_ntt_lanes(to_lanes(y, True, device), plan, sched),
                                         True))
    return out


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 6)
    out = compute(logn, batch, device)
    ok = check_result(out["spectrum"], out["engine"])
    ok &= check_result(out["back"], out["x"])
    ok &= check_result(out["spectrum_ordered"], out["engine_ordered"])
    ok &= check_result(out["back_ordered"], out["y"])
    print("All Correct." if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
