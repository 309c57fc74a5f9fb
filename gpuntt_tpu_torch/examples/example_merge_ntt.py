"""Device merge-NTT example — `gpu_merge_ntt_examples` parity.

Three sections, mirroring test_merge_ntt.cu:
  1. device forward NTT bit-exact vs NTTCPU::ntt (:70-175)
  2. signed (centered) input -> unsigned spectrum (:184-341)
  3. PerCoefficient layout == transpose . PerPolynomial . transpose
     (:343-474)

On the card, u64 rings of 2^12-2^17 take K1 (csrc/merge_u64.cu
merge_u64_forward) in all three sections; bigger rings the big-ring
composition.

Usage: python -m gpuntt_tpu_torch.examples.example_merge_ntt [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import NTTCPU, NTTLayout, NTTParameters, ReductionPolynomial, check_result
from ..ops.dispatch import ntt
from ..ops.merge_ntt import MergePlan
from . import _device


def params(logn: int) -> NTTParameters:
    return NTTParameters(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """The inputs and the three sections' outputs."""
    p = params(logn)
    plan = MergePlan.from_params(p, device=device)
    q = p.modulus.value
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(batch, p.n), dtype=np.uint64)
    mag = rng.integers(0, q // 2, size=(batch, p.n), dtype=np.uint64)
    sign = rng.integers(0, 2, size=(batch, p.n)) * 2 - 1
    x_signed = (mag.astype(np.int64) * sign).astype(np.int64)
    return dict(x=x, x_signed=x_signed, ntt=ntt(x, plan), ntt_signed=ntt(x_signed, plan),
                ntt_coef=ntt(np.ascontiguousarray(x.T), plan, layout=NTTLayout.PerCoefficient))


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 4)
    out = compute(logn, batch, device)
    p = params(logn)
    gen = NTTCPU(p)
    q = p.modulus.value

    # 1. unsigned forward parity
    exp = gen.ntt(out["x"])
    ok = check_result(out["ntt"], exp)
    # 2. signed input (values centered around 0)
    x_signed = out["x_signed"]
    unsigned = np.where(x_signed < 0, x_signed + q, x_signed).astype(np.uint64)
    ok &= check_result(out["ntt_signed"], gen.ntt(unsigned))
    # 3. PerCoefficient layout on an (N, batch) buffer
    ok &= check_result(out["ntt_coef"], exp.T)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
