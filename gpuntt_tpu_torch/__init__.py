"""gpuntt_tpu_torch — the gpuntt_tpu NTT framework on PyTorch and CUDA.

A port of the JAX package `gpuntt_tpu` to PyTorch, with hand-written
kernels for NVIDIA Hopper (sm_90a).  This first slice covers the u64
merge NTT main path:

- the host layers (moduli, prime and root pools, twiddle tables, golden
  models) copied from gpuntt_tpu;
- exact modular arithmetic on int64 tensors that hold u64 bit patterns;
- the merged radix-2 butterfly engine in plain PyTorch, on any device;
- three CUDA kernels (forward, inverse, fused polymul inverse) for u64
  rings of 2^12..2^17 with q < 2^62, built from csrc/ at first launch,
  each with a plain PyTorch version that CPU tensors take;
- the merge entries of the transform API and PolynomialMultiplier.

It imports torch and never jax.
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
from .reference.merge_cpu import NTTCPU
from .reference.schoolbook import schoolbook_poly_multiplication
from .ops.merge_ntt import MergePlan
from .ops.dispatch import (
    NTTConfig,
    intt,
    intt_lanes,
    ntt,
    ntt_lanes,
    pointwise_mult,
    pointwise_mult_lanes,
    polymul,
    polymul_lanes,
)
from .arith.host import (crt_reconstruct, find_ntt_primes, is_prime_u64,
                         ntt_root_pair)
from .models.polymul import PolynomialMultiplier

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
    "bitreverse",
    "bitrev_permute",
    "NTTFactors",
    "NTTLayout",
    "NTTParameters",
    "NTTType",
    "ReductionPolynomial",
    "NTTCPU",
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
    "crt_reconstruct",
    "find_ntt_primes",
    "is_prime_u64",
    "ntt_root_pair",
    "PolynomialMultiplier",
]
