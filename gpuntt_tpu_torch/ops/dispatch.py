"""Public transform API — the GPU_NTT / GPU_INTT equivalent surface.

The port of the JAX package's merge entries (ops/dispatch.py):

  ntt / intt, ntt_lanes / intt_lanes   <- GPU_NTT / GPU_INTT
  pointwise_mult(_lanes)               <- NTTCPU::mult on the device
  polymul(_lanes)                      <- ntt, mult, intt as one pipeline

The `*_lanes` entries take int64 tensors (u64 bit patterns, or u32
values) and a MergePlan; `ntt`/`intt`/`pointwise_mult`/`polymul` take
numpy arrays and run on the plan's device.

Layout semantics (NTTLayout, ntt.cuh doc :360-394): PerPolynomial
transforms the last axis of a (batch, N) buffer; PerCoefficient
transforms axis 0 of an (N, batch) buffer, here an axis move before and
after.  Signed variants (Data32s/Data64s, ntt.cu:4508-5244):
`signed_input` reduces on load, `signed_output` applies the centered
reduction after the inverse.  `NTTConfig.zero_padding` and
`NTTConfig.mod_inverse` are accepted and ignored, as in the JAX
package.

Route (`_kernel_path`), for a genuine root of unity and a 2-D
PerPolynomial batch (1-D, 3-D and PerCoefficient inputs are reshaped to
one first):

- u64, q < 2^62, logn 12-17 -> the hand-written kernels of
  hopper_merge.py ("hopper-merge"), both directions and the fused
  polymul;
- u64, q < 2^62, logn 18-28 -> the big-ring composition of
  hopper_merge_large.py ("hopper-merge-large"): K7's counterpart on the
  columns, and on the rows K8's (B <= 512), hopper_merge.py's (2^11..2^17)
  or a nested plan; the polymul fuses its product into K3's row inverse
  at logn 18-25, as the JAX route does, and runs it unfused at 26-28.
  The u64 logn-17 inverse stays on hopper_merge.py: the JAX package
  sends it to its large-ring route only for a v5e VMEM limit
  (gpuntt_tpu/ops/dispatch.py:66-70) that the card does not have;
- u32, q < 2^30, logn 8-25 -> those of hopper_merge32.py
  ("hopper-merge32"), both directions; the u32 polymul is the forward
  kernel twice, the plain Barrett product, then the inverse kernel, as
  the JAX package leaves the u32 product to XLA;
- everything else -> the torch butterfly engine ("engine").

The wrappers run their plain versions for CPU tensors.

`staged_ntt_lanes` / `staged_polymul_lanes` keep the JAX package's
big-ring entries (logn 24-28): thin calls into the same route.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..params.merge import NTTLayout, NTTType, ReductionPolynomial
from . import barrett as bo
from . import hopper_merge as hm
from . import hopper_merge32 as hm32
from . import hopper_merge_large as hml
from .merge_ntt import MergePlan, from_lanes, merge_intt_lanes, merge_ntt_lanes, to_lanes


@dataclass(frozen=True)
class NTTConfig:
    """Parity stand-in for ntt_configuration (ntt.cuh:31-51)."""

    n_power: int
    ntt_type: NTTType = NTTType.FORWARD
    ntt_layout: NTTLayout = NTTLayout.PerPolynomial
    reduction_poly: ReductionPolynomial = ReductionPolynomial.X_N_minus
    zero_padding: bool = False  # accepted, never read (parity)
    mod_inverse: int | None = None  # accepted, never read (parity)


def _kernel_path(plan: MergePlan, x_shape, layout: NTTLayout) -> str:
    """"hopper-merge", "hopper-merge-large", "hopper-merge32" or "engine"
    for a transform (same in both directions; the JAX package's TPU
    thresholds do not apply)."""
    if layout != NTTLayout.PerPolynomial or len(x_shape) != 2 or not plan.genuine_root:
        return "engine"
    if hm.covers(plan):
        return "hopper-merge"
    if hml.covers(plan):
        return "hopper-merge-large"
    if hm32.covers(plan):
        return "hopper-merge32"
    return "engine"


# path -> (forward, inverse) on a contiguous (batch, N) lane tensor
_TRANSFORMS = {
    "hopper-merge": (hm.merge_u64_fwd, hm.merge_u64_inv),
    "hopper-merge-large": (hml.merge_u64_large_fwd, hml.merge_u64_large_inv),
    "hopper-merge32": (hm32.merge_u32_fwd, hm32.merge_u32_inv),
    "engine": (merge_ntt_lanes, merge_intt_lanes),
}


def _apply_layout_in(x, layout: NTTLayout):
    if layout == NTTLayout.PerCoefficient:
        return x.movedim(0, -1)
    return x


def _apply_layout_out(x, layout: NTTLayout):
    if layout == NTTLayout.PerCoefficient:
        return x.movedim(-1, 0)
    return x


def _as_batch(x):
    """(..., N) -> contiguous (batch, N): the kernels are 2-D, and a 1-D
    or 3-D shape must not change the route."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def ntt_lanes(x: torch.Tensor, plan: MergePlan,
              layout: NTTLayout = NTTLayout.PerPolynomial,
              signed_input: bool = False) -> torch.Tensor:
    """Forward NTT on lane tensors (bit-reversed output order)."""
    plan = plan.to(x.device)
    if signed_input:
        x = (bo.reduce_signed64(x, plan.q) if plan.is64
             else bo.reduce_signed32(x, plan.q))
    x = _apply_layout_in(x, layout)
    shape = x.shape
    x2 = _as_batch(x)
    y = _TRANSFORMS[_kernel_path(plan, x2.shape, NTTLayout.PerPolynomial)][0](x2, plan)
    return _apply_layout_out(y.reshape(shape), layout)


def intt_lanes(x: torch.Tensor, plan: MergePlan,
               layout: NTTLayout = NTTLayout.PerPolynomial,
               signed_output: bool = False) -> torch.Tensor:
    """Inverse NTT on lane tensors, n^-1 scaling included."""
    plan = plan.to(x.device)
    x = _apply_layout_in(x, layout)
    shape = x.shape
    x2 = _as_batch(x)
    y = _TRANSFORMS[_kernel_path(plan, x2.shape, NTTLayout.PerPolynomial)][1](x2, plan)
    y = _apply_layout_out(y.reshape(shape), layout)
    if signed_output:
        return bo.centered64(y, plan.q) if plan.is64 else bo.centered32(y, plan.q)
    return y


def pointwise_mult_lanes(a: torch.Tensor, b: torch.Tensor, plan: MergePlan):
    """Elementwise a*b mod q, exact Barrett with the reference schedule
    (modular_arith.cuh:316-338)."""
    if plan.is64:
        return bo.barrett_mul64(a, b, plan.q, plan.bit, plan.mu)
    return bo.barrett_mul32(a, b, plan.q, plan.bit, plan.mu)


def polymul_lanes(a: torch.Tensor, b: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """INTT(NTT(a) o NTT(b)): cyclic for X_N_minus, negacyclic for
    X_N_plus.  On the u64 kernel routes the pointwise product is fused
    into the inverse kernel (K3; for big rings where its rows run on K3,
    logn 18-25); elsewhere it runs between the forward and inverse
    transforms.  Outputs are bit-identical on every route."""
    plan = plan.to(a.device)
    fa = _as_batch(ntt_lanes(a, plan))
    fb = _as_batch(ntt_lanes(b, plan))
    path = _kernel_path(plan, fa.shape, NTTLayout.PerPolynomial)
    if path == "hopper-merge":
        out = hm.merge_u64_polymul_inv(fa, fb, plan)
    elif path == "hopper-merge-large" and (lp := hml.large_plan(plan)).fuses_product:
        out = hml.merge_u64_large_polymul_inv(fa, fb, lp)
    else:
        out = intt_lanes(pointwise_mult_lanes(fa, fb, plan), plan)
    return out.reshape(a.shape)


# ---------------------------------------------- big-ring entries (24-28)


def staged_ntt_lanes(x_lanes: torch.Tensor, plan: MergePlan,
                     layout: NTTLayout = NTTLayout.PerPolynomial, inverse: bool = False,
                     signed_input: bool = False, signed_output: bool = False):
    """The JAX package's eager big-ring entry (gpuntt_tpu/ops/dispatch.py:
    295-370): the transform of a 2-D lane tensor at logn 24-28 on the
    kernel route, or None where that entry returns None — a tensor off
    the card (the JAX entry asks for a TPU backend), another logn, a
    shape that is not 2-D, u32 with q >= 2^30 or logn > 25, u64 with
    q >= 2^62, factors that are no root of unity."""
    if (not x_lanes.is_cuda or not 24 <= plan.logn <= 28 or x_lanes.dim() != 2
            or not plan.genuine_root):
        return None
    if plan.q >= (1 << (62 if plan.is64 else 30)) or (not plan.is64 and plan.logn > 25):
        return None
    if signed_input:
        x_lanes = (bo.reduce_signed64(x_lanes, plan.q) if plan.is64
                   else bo.reduce_signed32(x_lanes, plan.q))
    y = (intt_lanes if inverse else ntt_lanes)(x_lanes, plan, layout=layout)
    if signed_output:
        return bo.centered64(y, plan.q) if plan.is64 else bo.centered32(y, plan.q)
    return y


def staged_polymul_lanes(a_lanes: torch.Tensor, b_lanes: torch.Tensor, plan: MergePlan):
    """The JAX package's eager big-ring polymul (gpuntt_tpu/ops/dispatch.py:
    383-408): polymul_lanes at u64 logn 24-28 on the card, or None where
    that entry returns None (off the card, u32, q >= 2^62, another logn,
    a shape that is not 2-D, factors that are no root of unity)."""
    if (not a_lanes.is_cuda or not plan.is64 or plan.q >= (1 << 62)
            or not 24 <= plan.logn <= 28 or a_lanes.dim() != 2 or not plan.genuine_root):
        return None
    return polymul_lanes(a_lanes, b_lanes, plan)


# ------------------------------------------------------ numpy convenience


def _signed_view(x):
    """numpy int32/int64 -> same-width unsigned bit pattern."""
    x = np.asarray(x)
    if x.dtype == np.int32:
        return x.view(np.uint32)
    if x.dtype == np.int64:
        return x.view(np.uint64)
    raise TypeError(f"signed input must be int32/int64, got {x.dtype}")


def ntt(x, plan: MergePlan, cfg: NTTConfig | None = None, **kw) -> np.ndarray:
    """GPU_NTT equivalent over numpy arrays (uint32/uint64, or
    int32/int64 with signed-input semantics)."""
    layout = kw.pop("layout", cfg.ntt_layout if cfg else NTTLayout.PerPolynomial)
    signed_input = kw.pop("signed_input", False)
    x = np.asarray(x)
    if x.dtype in (np.dtype(np.int32), np.dtype(np.int64)):
        x = _signed_view(x)
        signed_input = True
    lanes = to_lanes(x, plan.is64, plan.device)
    y = ntt_lanes(lanes, plan, layout=layout, signed_input=signed_input)
    return from_lanes(y, plan.is64)


def intt(x, plan: MergePlan, cfg: NTTConfig | None = None, **kw) -> np.ndarray:
    """GPU_INTT equivalent over numpy arrays."""
    layout = kw.pop("layout", cfg.ntt_layout if cfg else NTTLayout.PerPolynomial)
    signed_output = kw.pop("signed_output", False)
    lanes = to_lanes(np.asarray(x), plan.is64, plan.device)
    res = from_lanes(intt_lanes(lanes, plan, layout=layout,
                                signed_output=signed_output), plan.is64)
    if signed_output:
        return res.view(np.int64) if plan.is64 else res.view(np.int32)
    return res


def pointwise_mult(x, y, plan: MergePlan) -> np.ndarray:
    """NTT-domain pointwise product over numpy arrays."""
    xl = to_lanes(np.asarray(x), plan.is64, plan.device)
    yl = to_lanes(np.asarray(y), plan.is64, plan.device)
    return from_lanes(pointwise_mult_lanes(xl, yl, plan), plan.is64)


def polymul(x, y, plan: MergePlan) -> np.ndarray:
    """Polynomial multiplication over numpy (batch, N) arrays — the
    reference example flow (test_cpu_merge_ntt.cu:70-77: ntt, mult,
    intt); bit-exact vs schoolbook_poly_multiplication for the plan's
    reduction polynomial."""
    xl = to_lanes(np.asarray(x), plan.is64, plan.device)
    yl = to_lanes(np.asarray(y), plan.is64, plan.device)
    return from_lanes(polymul_lanes(xl, yl, plan), plan.is64)
