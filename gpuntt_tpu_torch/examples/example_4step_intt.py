"""Device 4-step INTT example — `gpu_4step_intt_examples` parity.

intt_first_transpose pre-permute -> 4-step inverse core -> transpose,
bit-exact vs NTT_4STEP_CPU::intt (test_4step_intt.cu:83-88, :151-179).
fourstep_intt_full bundles the input permute, the inverse core with
fused n^-1, and the final transpose.  The JAX script jits it; here it is
a plain call.

On the card: K9's inverse column kernel (csrc/fourstep.cu) and K10's row
kernel for rows of at most 512 words (2^16 = 128 x 512); longer rows K2.

Usage: python -m gpuntt_tpu_torch.examples.example_4step_intt [RING_SIZE_IN_LOG2] [BATCH_SIZE] [--device=cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result
from ..ops.fourstep import FourStepPlan, fourstep_intt_full
from ..ops.merge_ntt import from_lanes, to_lanes
from . import _device


def params(logn: int) -> NTTParameters4Step:
    return NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """The input and the inverse pipeline's output."""
    p = params(logn)
    plan = FourStepPlan.from_params(p, device=device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    return dict(x=x, intt=from_lanes(fourstep_intt_full(to_lanes(x, True, device), plan), True))


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 4)
    out = compute(logn, batch, device)
    gen = NTT4StepCPU(params(logn))
    ok = check_result(out["intt"], np.stack([gen.intt(row) for row in out["x"]]))
    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
