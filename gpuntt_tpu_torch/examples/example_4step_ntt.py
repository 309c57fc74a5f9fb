"""Device 4-step NTT example — `gpu_4step_ntt_examples` parity.

transpose -> 4-step core -> transpose, bit-exact vs NTT_4STEP_CPU::ntt
(test_4step_ntt.cu:147-178).  The core keeps the reference's calling
convention: the first/last transposes are the caller's job
(ntt_4step.cuh:68-74), shown here explicitly with transpose_lanes.  The
JAX script jits the pipeline; here it is a plain call.

On the card, rings of 2^12-2^24 take the 4-step kernels: K9's column
kernel (csrc/fourstep.cu) and, for rows of at most 512 words (2^16 =
128 x 512), K10's row kernel (csrc/merge_u64_large.cu
merge_u64_large_rowmat); longer rows K1.

Usage: python -m gpuntt_tpu_torch.examples.example_4step_ntt [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result
from ..ops.fourstep import FourStepPlan, fourstep_ntt_lanes, transpose_lanes
from ..ops.merge_ntt import from_lanes, to_lanes
from . import _device


def params(logn: int) -> NTTParameters4Step:
    return NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """The input and the pipeline's output."""
    p = params(logn)
    plan = FourStepPlan.from_params(p, device=device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)

    v = transpose_lanes(to_lanes(x, True, device), plan.n1, plan.n2)  # caller-side step 0
    v = fourstep_ntt_lanes(v, plan)                                    # GPU_4STEP_NTT core
    v = transpose_lanes(v, plan.n1, plan.n2)                           # caller-side step 4
    return dict(x=x, ntt=from_lanes(v, True))


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 4)
    out = compute(logn, batch, device)
    gen = NTT4StepCPU(params(logn))
    ok = check_result(out["ntt"], np.stack([gen.ntt(row) for row in out["x"]]))
    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
