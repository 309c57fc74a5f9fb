"""gpuntt_tpu_torch — the gpuntt_tpu NTT framework on PyTorch and CUDA.

A port of the JAX package `gpuntt_tpu` to PyTorch, with hand-written
kernels for NVIDIA Hopper (sm_90a).  It covers the merge and 4-step NTT
paths of both word sizes so far:

- the host layers (moduli, prime and root pools, twiddle tables, golden
  models) copied from gpuntt_tpu;
- exact modular arithmetic on int64 tensors that hold u64 bit patterns
  or u32 values;
- the merged radix-2 butterfly engine in plain PyTorch, on any device;
- CUDA kernels built from csrc/ at first launch, each with a plain
  PyTorch version that CPU tensors take: the u64 forward, inverse and
  fused polymul inverse for rings of 2^12..2^17 with q < 2^62
  (ops.hopper_merge), the u64 big rings 2^18..2^28 as a column kernel
  and row kernels composed (ops.hopper_merge_large), and the u32 forward
  and inverse for rings of 2^8..2^25 with q < 2^30 (ops.hopper_merge32),
  and the 4-step's column and row kernels at logn 12-24, both word sizes
  (ops.hopper_fourstep);
- the merge entries of the transform API and PolynomialMultiplier;
- the 4-step entries (`fourstep_{ntt,intt}_{lanes,full}`,
  `transpose_lanes`), FourStepPlan, NTTParameters4Step and the golden
  NTT4StepCPU;
- the RNS entries (`ntt_rns`, `intt_rns`, the modulus- and
  poly-ordered schedules, `rns_pointwise_mult(_lanes)`, `rns_polymul`),
  RNSMergePlan, the RNS 4-step (`RNSFourStepPlan`,
  `rns_fourstep_{ntt,intt}_{lanes,full}`) and RNSPolynomialMultiplier,
  on the u64 RNS kernels (ops.hopper_rns: K12 at logn 12-17, K13 at
  18-23, K14 for the 4-step at 14-23) and, for u32 ladders with every
  q < 2^30, the stacked u32 kernels at logn 8-25 (ops.hopper_rns32).

Entry points run on the first CUDA card unless the caller passes
device="cpu"; without a card, a plan made for the default device raises
NTTDeviceError.  It imports torch and never jax.
"""

from .arith.modulus import Modulus, Modulus32, Modulus64
from .arith import host as OPERATOR
from .common.check import check_result
from .common.device import available_devices, default_device, device_summary
from .common.errors import (
    NTTError,
    NTTParameterError,
    NTTDeviceError,
    NTTDispatchError,
)
from .params.bitrev import bitreverse, bitrev_permute
from .params.merge import (
    NTTFactors,
    NTTLayout,
    NTTParameters,
    NTTType,
    ReductionPolynomial,
)
from .params.fourstep import MATRIX_DIMENSIONS, NTTParameters4Step
from .reference.fourstep_cpu import NTT4StepCPU
from .reference.merge_cpu import NTTCPU
from .reference.schoolbook import schoolbook_poly_multiplication
from .ops.merge_ntt import MergePlan
from .ops.fourstep import (
    FourStepPlan,
    fourstep_intt_full,
    fourstep_intt_lanes,
    fourstep_ntt_full,
    fourstep_ntt_lanes,
    transpose_lanes,
)
from .ops.dispatch import (
    NTTConfig,
    intt,
    intt_lanes,
    intt_modulus_ordered,
    intt_poly_ordered,
    intt_rns,
    ntt,
    ntt_lanes,
    ntt_modulus_ordered,
    ntt_poly_ordered,
    ntt_rns,
    pointwise_mult,
    pointwise_mult_lanes,
    polymul,
    polymul_lanes,
    rns_pointwise_mult,
    rns_pointwise_mult_lanes,
    rns_polymul,
)
from .ops.rns import NTTScheduleError, RNSMergePlan
from .ops.fourstep_rns import (
    RNSFourStepPlan,
    rns_fourstep_intt_full,
    rns_fourstep_intt_lanes,
    rns_fourstep_ntt_full,
    rns_fourstep_ntt_lanes,
)
from .arith.host import (crt_reconstruct, find_ntt_primes, is_prime_u64,
                         ntt_root_pair)
from .models.polymul import PolynomialMultiplier, RNSPolynomialMultiplier

__version__ = "0.1.0"

__all__ = [
    "Modulus",
    "Modulus32",
    "Modulus64",
    "OPERATOR",
    "check_result",
    "available_devices",
    "default_device",
    "device_summary",
    "NTTError",
    "NTTParameterError",
    "NTTDeviceError",
    "NTTDispatchError",
    "NTTScheduleError",
    "bitreverse",
    "bitrev_permute",
    "NTTFactors",
    "NTTLayout",
    "NTTParameters",
    "NTTType",
    "ReductionPolynomial",
    "NTTCPU",
    "MATRIX_DIMENSIONS",
    "NTTParameters4Step",
    "NTT4StepCPU",
    "FourStepPlan",
    "fourstep_ntt_lanes",
    "fourstep_intt_lanes",
    "fourstep_ntt_full",
    "fourstep_intt_full",
    "transpose_lanes",
    "schoolbook_poly_multiplication",
    "MergePlan",
    "NTTConfig",
    "intt",
    "intt_lanes",
    "ntt",
    "ntt_lanes",
    "pointwise_mult",
    "pointwise_mult_lanes",
    "polymul",
    "polymul_lanes",
    "intt_modulus_ordered",
    "intt_poly_ordered",
    "intt_rns",
    "ntt_modulus_ordered",
    "ntt_poly_ordered",
    "ntt_rns",
    "rns_pointwise_mult",
    "rns_pointwise_mult_lanes",
    "rns_polymul",
    "RNSMergePlan",
    "RNSFourStepPlan",
    "rns_fourstep_ntt_lanes",
    "rns_fourstep_intt_lanes",
    "rns_fourstep_ntt_full",
    "rns_fourstep_intt_full",
    "crt_reconstruct",
    "find_ntt_primes",
    "is_prime_u64",
    "ntt_root_pair",
    "PolynomialMultiplier",
    "RNSPolynomialMultiplier",
]
