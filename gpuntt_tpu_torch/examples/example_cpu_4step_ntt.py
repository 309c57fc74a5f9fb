"""CPU 4-step NTT example — `cpu_4step_ntt_examples` parity.

Round-trip property of the 4-step golden model: NTT -> pointwise mult
-> INTT equals schoolbook mod X^N - 1 (test_cpu_4step_ntt.cu:64-78).
It runs on the host whatever `--device` says.

Usage: python -m gpuntt_tpu_torch.examples.example_cpu_4step_ntt [RING_SIZE_IN_LOG2] [BATCH_SIZE]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import (NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result,
                schoolbook_poly_multiplication)
from . import _device


def main(argv=None) -> int:
    args, _ = _device.split(sys.argv[1:] if argv is None else argv)
    logn = int(args[0]) if args else 12
    batch = int(args[1]) if len(args) > 1 else 1

    p = NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)
    gen = NTT4StepCPU(p)
    q = p.modulus.value
    rng = np.random.default_rng(0)

    ok = True
    for _ in range(batch):
        a = rng.integers(0, q, size=p.n, dtype=np.uint64)
        b = rng.integers(0, q, size=p.n, dtype=np.uint64)
        got = gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
        exp = schoolbook_poly_multiplication(a, b, p.modulus, ReductionPolynomial.X_N_minus)
        ok &= check_result(got, exp)

    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
