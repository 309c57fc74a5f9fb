"""Device merge-INTT example — `gpu_merge_intt_examples` parity.

Three sections, mirroring test_merge_intt.cu:
  1. device inverse NTT bit-exact vs NTTCPU::intt (:46-200)
  2. signed-output INTT via centered reduction (:205-370)
  3. PerCoefficient layout check (:475-506)

On the card, u64 rings of 2^12-2^17 take K2 (csrc/merge_u64.cu
merge_u64_inverse) in all three sections.

Usage: python -m gpuntt_tpu_torch.examples.example_merge_intt [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import NTTCPU, NTTLayout, NTTParameters, ReductionPolynomial, check_result
from ..ops.dispatch import intt
from ..ops.merge_ntt import MergePlan
from . import _device


def params(logn: int) -> NTTParameters:
    return NTTParameters(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """The input and the three sections' outputs."""
    p = params(logn)
    plan = MergePlan.from_params(p, device=device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    return dict(x=x, intt=intt(x, plan), intt_signed=intt(x, plan, signed_output=True),
                intt_coef=intt(np.ascontiguousarray(x.T), plan,
                               layout=NTTLayout.PerCoefficient))


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 4)
    out = compute(logn, batch, device)
    p = params(logn)
    q = p.modulus.value

    # 1. unsigned inverse parity
    exp = NTTCPU(p).intt(out["x"])
    ok = check_result(out["intt"], exp)
    # 2. signed output: centered representatives in [-q/2, q/2)
    half = q >> 1
    exp_s = np.where(exp > half, exp.astype(np.int64) - q, exp.astype(np.int64))
    ok &= check_result(out["intt_signed"], exp_s)
    # 3. PerCoefficient layout on an (N, batch) buffer
    ok &= check_result(out["intt_coef"], exp.T)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
