"""K15's Hopper kernel, the u64 factored merge NTT, with its plain version.

The counterpart of the JAX package's ops/pallas_merge64.py:

    kmerge_u64(x, plan)                <- _fwd_kernel64 (pallas_merge64.py:74)
    kmerge_u64(x, plan, inverse=True)  <- _inv_kernel64 (pallas_merge64.py:105)

on a contiguous (batch, N) int64 tensor of u64 bit patterns and a u64
KernelMergePlan (hopper_kmerge.py) on the same device: the bit-reversed
merge NTT in canonical residues, and its inverse with n^-1, any input
word reduced mod q first.  It runs on csrc/kmerge.cu's register passes:
lazy butterflies (values below 4q) for q < 2^62, and for q in [2^62,
2^63), where 4q no longer fits 64 bits, a canonical instance of the
same passes (every sum below 2q), which the C entry picks from q.  So
it takes every q < 2^63, past the q < 2^62 of the u64 kernels of
merge_u64.cu.

The JAX package reaches K15 through ntt_lanes / intt_lanes with any
`use_pallas` string that names no MXU path (such as "vpu") on a u64 plan
(gpuntt_tpu/ops/dispatch.py:228-234, :273-277), whatever its factors,
and polymul_lanes through them, unfused.  Dispatch sends the same calls
here (the route "hopper-kmerge64", `route`): logn 7-24, q < 2^63, any
factors, as the JAX package builds its plan from whatever root it is
given.  Above logn 24 it raises NTTDispatchError, as it does below logn
7, where JAX's plan asserts A >= 1, and for a plan of the
evaluation-twisted transform (MergePlan.from_eval, which the JAX
package's MergePlan has no counterpart of): the kernel plan is built
from the root pair alone.

On a CPU tensor the wrapper runs the kernel's plain version, and only
there; on a CUDA tensor it launches the kernel (hopper_kmerge.kmerge) or
raises.  Every launch
adds one to its kernel's `launches`, every plain-version call one to
`plain_calls`; `tracing.reset()` zeroes them.
"""

from __future__ import annotations

import torch

from ..common.errors import NTTDispatchError
from ..common.tracing import KernelStats
from . import kernel
from .hopper_kmerge import SOURCE, KernelMergePlan, kernel_plan, kmerge
from .merge_ntt import MergePlan

FORWARD = KernelStats("kmerge_u64_forward", "gpuntt_tpu/ops/pallas_merge64.py:74",
                      source=SOURCE)
INVERSE = KernelStats("kmerge_u64_inverse", "gpuntt_tpu/ops/pallas_merge64.py:105",
                      source=SOURCE)
KERNELS = (FORWARD, INVERSE)
# lazy butterflies up to 2^62 and a canonical instance past it (Shoup products need
# q < 2^63); the W table's size caps the ring; the "vpu" route sends every plan taken
FAMILY = kernel.Family(word=64, q_bits=63, takes=(7, 24), routes=(7, 24))


def route(plan: MergePlan) -> str:
    """The route of a u64 plan under a non-MXU `use_pallas` string,
    "hopper-kmerge64"; raises NTTDispatchError outside logn 7-24, for
    q >= 2^63 and for an evaluation-twisted plan (`FAMILY.routes`)."""
    lo, hi = FAMILY.routes
    if not lo <= plan.logn <= hi:
        raise NTTDispatchError(
            f'use_pallas="vpu" on u64 runs K15\'s counterpart at logn {lo}-{hi}, got '
            f"logn={plan.logn}" + (
                f": its (A, 128) W table and companion would take "
                f"{2 * 8 << plan.logn} bytes per direction" if plan.logn > hi else
                " (A = N / 128 >= 1)"))
    if not FAMILY.covers(plan.is64, plan.q, plan.logn):
        raise NTTDispatchError(f"K15's counterpart needs q < 2^{FAMILY.q_bits} (Shoup "
                               f"products), got q={plan.q}")
    if plan.twist is not None:
        raise NTTDispatchError("K15's counterpart has no evaluation twist: its plan is "
                               "built from the root pair alone (use_pallas=\"auto\" or "
                               "False take a from_eval plan)")
    return "hopper-kmerge64"


def kmerge_u64(x: torch.Tensor, plan: KernelMergePlan, inverse: bool = False) -> torch.Tensor:
    """K15's counterpart (pallas_merge2_u64): the merged NTT of each row,
    bit-reversed output order, or with inverse=True its inverse with
    n^-1; canonical output.  u64 plans with q < 2^63, logn 7-24."""
    return kmerge(FAMILY, INVERSE if inverse else FORWARD, x, plan, inverse)


def merge_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """The route's forward: kmerge_u64 on the MergePlan's cached plan."""
    return kmerge_u64(x, kernel_plan(plan))


def merge_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    return kmerge_u64(x, kernel_plan(plan), inverse=True)
