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

The wrappers run their plain versions for CPU tensors.  `use_pallas` on
ntt_lanes / intt_lanes / polymul_lanes picks the route as the JAX
package's argument does (`_chosen_path`).

`staged_ntt_lanes` / `staged_polymul_lanes` keep the JAX package's
big-ring entries (logn 24-28): thin calls into the same route.

The RNS entries (gpuntt_tpu/ops/dispatch.py:481-848) take numpy arrays
and an RNSMergePlan (ops/rns.py): ntt_rns / intt_rns (row b under
modulus b % mod_count), ntt/intt_modulus_ordered, ntt/intt_poly_ordered,
rns_pointwise_mult(_lanes) and rns_polymul, over the lanes-level
pipelines ntt_rns_lanes, intt_rns_lanes and rns_polymul_lanes (the last
is what RNSPolynomialMultiplier calls).
Route (`_rns_kernel_path`), for a (batch, N) tensor and members that
all have a genuine root:

- u64, every q < 2^62, logn 12-17 -> K12 ("hopper-rns"), logn 18-23 ->
  K13 ("hopper-rns-large"), both in hopper_rns.py;
- u32, every q < 2^30, logn 8-25 -> the stacked u32 kernels of
  hopper_rns32.py ("hopper-rns32", K16's counterpart), which the JAX
  package leaves to XLA; the polymul fuses its product into the inverse;
- everything else (other logn, wide q) -> the engine of ops/rns.py.

A schedule of one entry serves every row; any other length that is not
the batch raises NTTScheduleError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..common.errors import NTTDispatchError
from ..params.merge import NTTLayout, NTTType, ReductionPolynomial
from . import barrett as bo
from . import hopper_merge as hm
from . import hopper_merge32 as hm32
from . import hopper_merge_large as hml
from . import hopper_rns as hr
from . import hopper_rns32 as hr32
from .merge_ntt import MergePlan, from_lanes, merge_intt_lanes, merge_ntt_lanes, to_lanes
from .rns import (NTTScheduleError, RNSMergePlan, checked_schedule, per_modulus,
                  rns_intt_lanes, rns_ntt_lanes)


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

# the JAX package's kernel-path names (gpuntt_tpu/ops/dispatch.py:112) and
# the route of their counterparts here
_NAMED_PATHS = {"mxu": ("hopper-merge", hm), "mxu-large": ("hopper-merge-large", hml),
                "mxu32": ("hopper-merge32", hm32), "mxu32-large": ("hopper-merge32", hm32)}


def _chosen_path(plan: MergePlan, x_shape, use_pallas) -> str:
    """The route of a (batch, N) transform under `use_pallas`, read as the
    JAX package reads it (gpuntt_tpu/ops/dispatch.py:221-239): "auto" and
    True take the plan's kernel route (no backend to check here), False
    the engine; a JAX path name takes its counterpart, or the engine
    where that kernel does not take the plan (as _resolve_mxu falls to
    XLA); any other true value names the VPU merge kernel, K4's
    counterpart on u32.  Its u64 twin K15 is not ported: that raises."""
    if use_pallas == "auto" or use_pallas is True:
        return _kernel_path(plan, x_shape, NTTLayout.PerPolynomial)
    if not use_pallas:
        return "engine"
    if use_pallas in _NAMED_PATHS:
        path, kernels = _NAMED_PATHS[use_pallas]
        return path if kernels.covers(plan) and plan.genuine_root else "engine"
    if plan.is64:
        raise NTTDispatchError(
            f"use_pallas={use_pallas!r} names the u64 VPU merge kernel K15 "
            "(gpuntt_tpu/ops/pallas_merge64.py), which has no Hopper counterpart yet")
    return "hopper-merge32" if hm32.covers(plan) else "engine"


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
              signed_input: bool = False, use_pallas: bool | str = "auto") -> torch.Tensor:
    """Forward NTT on lane tensors (bit-reversed output order), on the
    route `use_pallas` picks (`_chosen_path`)."""
    plan = plan.to(x.device)
    if signed_input:
        x = (bo.reduce_signed64(x, plan.q) if plan.is64
             else bo.reduce_signed32(x, plan.q))
    x = _apply_layout_in(x, layout)
    shape = x.shape
    x2 = _as_batch(x)
    y = _TRANSFORMS[_chosen_path(plan, x2.shape, use_pallas)][0](x2, plan)
    return _apply_layout_out(y.reshape(shape), layout)


def intt_lanes(x: torch.Tensor, plan: MergePlan,
               layout: NTTLayout = NTTLayout.PerPolynomial,
               signed_output: bool = False, use_pallas: bool | str = "auto") -> torch.Tensor:
    """Inverse NTT on lane tensors, n^-1 scaling included; `use_pallas`
    as in ntt_lanes."""
    plan = plan.to(x.device)
    x = _apply_layout_in(x, layout)
    shape = x.shape
    x2 = _as_batch(x)
    y = _TRANSFORMS[_chosen_path(plan, x2.shape, use_pallas)][1](x2, plan)
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


def polymul_lanes(a: torch.Tensor, b: torch.Tensor, plan: MergePlan,
                  use_pallas: bool | str = "auto") -> torch.Tensor:
    """INTT(NTT(a) o NTT(b)): cyclic for X_N_minus, negacyclic for
    X_N_plus.  With use_pallas="auto", on the u64 kernel routes the
    pointwise product is fused into the inverse kernel (K3; for big rings
    where its rows run on K3, logn 18-25); elsewhere, and for every other
    `use_pallas` (as in the JAX package), it runs between the forward and
    inverse transforms.  Outputs are bit-identical on every route."""
    plan = plan.to(a.device)
    fa = _as_batch(ntt_lanes(a, plan, use_pallas=use_pallas))
    fb = _as_batch(ntt_lanes(b, plan, use_pallas=use_pallas))
    path = (_kernel_path(plan, fa.shape, NTTLayout.PerPolynomial)
            if use_pallas == "auto" else None)
    if path == "hopper-merge":
        out = hm.merge_u64_polymul_inv(fa, fb, plan)
    elif path == "hopper-merge-large" and (lp := hml.large_plan(plan)).fuses_product:
        out = hml.merge_u64_large_polymul_inv(fa, fb, lp)
    else:
        out = intt_lanes(pointwise_mult_lanes(fa, fb, plan), plan, use_pallas=use_pallas)
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


# --------------------------------------------------------- RNS + ordered


def _rns_mod_idx(batch: int, mod_count: int) -> np.ndarray:
    """Default cyclic modulus schedule: batch b -> modulus b % mod_count
    (ntt.cu RNS kernels, q_index = block_y % mod_count)."""
    return np.arange(batch, dtype=np.int64) % mod_count


def _order_mod_idx(batch: int, plan: RNSMergePlan, order) -> np.ndarray:
    """The schedule of the pointwise and polymul entries: cyclic, or
    `order[b % len(order)]` with every entry in [0, mod_count)."""
    if order is None:
        return _rns_mod_idx(batch, plan.mod_count)
    order = np.asarray(order, dtype=np.int64)
    if order.size and (order.min() < 0 or order.max() >= plan.mod_count):
        raise ValueError(f"order entries must be in [0, {plan.mod_count}), got {order}")
    return _ordered(batch, order)


def _rns_kernel_path(plan: RNSMergePlan, x_shape) -> str:
    """"hopper-rns" (K12), "hopper-rns-large" (K13), "hopper-rns32" (K16's
    counterpart) or "engine" for an RNS transform of a (batch, N) tensor
    whose members all have a genuine root: u64 ladders with every
    q < 2^62 at logn 12-17 and 18-23 (the JAX package's q < 2^60 is a
    limit of its digit arithmetic; the Shoup butterflies are exact below
    2^62), u32 ladders with every q < 2^30 at logn 8-25.  The JAX package
    leaves u32 ladders to XLA, where its stacked kernel lost to it on the
    TPU (gpuntt_tpu/ops/dispatch.py:553-562); this card multiplies
    32 x 32 -> 64 natively."""
    if len(x_shape) != 2 or not plan.genuine_root:
        return "engine"
    if hr.covers(plan):
        return "hopper-rns"
    if hr.covers_large(plan):
        return "hopper-rns-large"
    if hr32.covers(plan):
        return "hopper-rns32"
    return "engine"


# path -> (forward, inverse, fused polymul inverse) on contiguous (batch, N)
# lane tensors and an int32 schedule on the card
_RNS_KERNELS = {
    "hopper-rns": (hr.rns_u64_fwd, hr.rns_u64_inv, hr.rns_u64_polymul_inv),
    "hopper-rns32": (hr32.rns_u32_fwd, hr32.rns_u32_inv, hr32.rns_u32_polymul_inv),
}


def _rns_transform(x: torch.Tensor, plan: RNSMergePlan, mod_idx, inverse: bool):
    plan = plan.to(x.device)
    mod_idx = checked_schedule(mod_idx, plan.mod_count, x.shape[0])
    path = _rns_kernel_path(plan, x.shape)
    if path == "engine":
        return (rns_intt_lanes if inverse else rns_ntt_lanes)(x, plan, mod_idx)
    x = x.contiguous()
    midx = hr.schedule(plan, mod_idx, x.device)
    if path == "hopper-rns-large":
        return hr.rns_u64_large(x, hr.large_plan(plan), midx, inverse)
    return _RNS_KERNELS[path][1 if inverse else 0](x, plan, midx)


def ntt_rns_lanes(x: torch.Tensor, plan: RNSMergePlan, mod_idx) -> torch.Tensor:
    """The RNS forward transform of a (batch, N) lane tensor on its route,
    row b under modulus mod_idx[b], read as jnp indexing reads it (one
    entry serves every row; any other length that is not the batch raises
    NTTScheduleError): the lanes-level pipeline under ntt_rns and the
    ordered entries."""
    return _rns_transform(x, plan, mod_idx, False)


def intt_rns_lanes(x: torch.Tensor, plan: RNSMergePlan, mod_idx) -> torch.Tensor:
    """The RNS inverse of ntt_rns_lanes, each row's n^-1 last."""
    return _rns_transform(x, plan, mod_idx, True)


def _rns_numpy(x, plan: RNSMergePlan, mod_idx, inverse: bool) -> np.ndarray:
    lanes = to_lanes(np.asarray(x), plan.is64, plan.device)
    return from_lanes(_rns_transform(lanes, plan, mod_idx, inverse), plan.is64)


def ntt_rns(x, plan: RNSMergePlan, cfg: NTTConfig | None = None) -> np.ndarray:
    """GPU_NTT RNS overload (ntt.cu:2560-2800) over a numpy (batch, N)
    array: row b under modulus b % mod_count."""
    x = np.asarray(x)
    return _rns_numpy(x, plan, _rns_mod_idx(x.shape[0], plan.mod_count), False)


def intt_rns(x, plan: RNSMergePlan, cfg: NTTConfig | None = None) -> np.ndarray:
    """GPU_INTT RNS overload (ntt.cu:2800-3059)."""
    x = np.asarray(x)
    return _rns_numpy(x, plan, _rns_mod_idx(x.shape[0], plan.mod_count), True)


def _ordered(batch: int, order) -> np.ndarray:
    """GPU_NTT_Modulus_Ordered's schedule: row b under order[b % len(order)]."""
    order = np.asarray(order, dtype=np.int64)
    return order[np.arange(batch) % len(order)]


def ntt_modulus_ordered(x, plan: RNSMergePlan, order,
                        cfg: NTTConfig | None = None) -> np.ndarray:
    """GPU_NTT_Modulus_Ordered (ntt.cu:3600-3768): row b under modulus
    order[b % len(order)].  `order` is not validated, as in the JAX
    package: its entries are read as jnp indexing reads them."""
    x = np.asarray(x)
    return _rns_numpy(x, plan, _ordered(len(x), order), False)


def intt_modulus_ordered(x, plan: RNSMergePlan, order,
                         cfg: NTTConfig | None = None) -> np.ndarray:
    x = np.asarray(x)
    return _rns_numpy(x, plan, _ordered(len(x), order), True)


def _poly_ordered(x, plan: RNSMergePlan, order, batch_size, inverse: bool) -> np.ndarray:
    """For b < batch_size, row order[b] transformed in place under modulus
    b % mod_count; other rows pass through.  Where `order` repeats a row
    the last occurrence wins, as the JAX package's numpy store
    (res[sel] = out) leaves it, so only last occurrences are transformed."""
    x = np.asarray(x)
    order = np.asarray(order, dtype=np.int64)
    b = batch_size if batch_size is not None else len(order)
    sel = np.arange(x.shape[0])[order[:b]]  # numpy's reading of `order`
    first_of_reversed = np.unique(sel[::-1], return_index=True)[1]
    keep = np.sort(len(sel) - 1 - first_of_reversed)
    res = x.copy()
    if keep.size:
        res[sel[keep]] = _rns_numpy(x[sel[keep]], plan, keep % plan.mod_count,
                                    inverse).astype(x.dtype)
    return res


def ntt_poly_ordered(x, plan: RNSMergePlan, order, batch_size: int | None = None,
                     cfg: NTTConfig | None = None) -> np.ndarray:
    """GPU_NTT_Poly_Ordered (ntt.cu:3782-4459)."""
    return _poly_ordered(x, plan, order, batch_size, False)


def intt_poly_ordered(x, plan: RNSMergePlan, order, batch_size: int | None = None,
                      cfg: NTTConfig | None = None) -> np.ndarray:
    return _poly_ordered(x, plan, order, batch_size, True)


def rns_pointwise_mult_lanes(a: torch.Tensor, b: torch.Tensor, plan: RNSMergePlan,
                             mod_idx) -> torch.Tensor:
    """RNS spectrum product: row r under modulus mod_idx[r], exact Barrett
    with that member's (q, bit, mu).  A row whose entry names no member
    1..mod_count-1 takes member 0's product, as the JAX package's
    where-chain leaves it.  The schedule broadcasts against the rows as
    that chain's (len, 1) mask does: one entry serves every row, and a
    schedule of k entries over one row gives k rows; any other length
    raises NTTScheduleError."""
    mod_idx = np.asarray(mod_idx, dtype=np.int64).reshape(-1)
    try:
        shape = torch.broadcast_shapes((len(mod_idx),) + (1,) * (a.dim() - 1), a.shape,
                                       b.shape)
    except RuntimeError as e:
        raise NTTScheduleError(f"a schedule of {len(mod_idx)} entries for operands "
                               f"{tuple(a.shape)} and {tuple(b.shape)}") from e
    named = (mod_idx >= 1) & (mod_idx < plan.mod_count)
    return per_modulus(lambda u, v, member: pointwise_mult_lanes(u, v, member), plan.members,
                       np.broadcast_to(np.where(named, mod_idx, 0), shape[:1]),
                       a.expand(shape), b.expand(shape))


def rns_pointwise_mult(x, y, plan: RNSMergePlan, order=None) -> np.ndarray:
    """NTT-domain RNS product over numpy arrays (cyclic schedule, or
    `order` as in GPU_NTT_Modulus_Ordered, each entry in [0, mod_count))."""
    x = np.asarray(x)
    mod_idx = _order_mod_idx(x.shape[0], plan, order)
    xl = to_lanes(x, plan.is64, plan.device)
    yl = to_lanes(np.asarray(y), plan.is64, plan.device)
    return from_lanes(rns_pointwise_mult_lanes(xl, yl, plan, mod_idx), plan.is64)


def rns_polymul_lanes(a: torch.Tensor, b: torch.Tensor, plan: RNSMergePlan,
                      mod_idx) -> torch.Tensor:
    """INTT(NTT(a) o NTT(b)) of (batch, N) lane tensors, row r modulo
    (q_{mod_idx[r]}, X^N +/- 1), the schedule read as ntt_rns_lanes reads
    it.  On the kernel routes: two forward transforms and the inverse
    with the product fused into its first load (K12's fused inverse and
    its u32 twin, on the rows of a big ring for K13); on the engine:
    forward, rns_pointwise_mult_lanes, inverse.  Outputs are bit-identical
    either way."""
    plan = plan.to(a.device)
    mod_idx = checked_schedule(mod_idx, plan.mod_count, a.shape[0])
    path = _rns_kernel_path(plan, a.shape)
    if path == "engine":
        prod = rns_pointwise_mult_lanes(rns_ntt_lanes(a, plan, mod_idx),
                                        rns_ntt_lanes(b, plan, mod_idx), plan, mod_idx)
        return rns_intt_lanes(prod, plan, mod_idx)
    a, b = a.contiguous(), b.contiguous()
    midx = hr.schedule(plan, mod_idx, a.device)
    if path == "hopper-rns-large":
        sp = hr.large_plan(plan)
        return hr.rns_u64_large_polymul_inv(hr.rns_u64_large(a, sp, midx),
                                            hr.rns_u64_large(b, sp, midx), sp, midx)
    fwd, _, polymul_inv = _RNS_KERNELS[path]
    return polymul_inv(fwd(a, plan, midx), fwd(b, plan, midx), plan, midx)


def rns_polymul(x, y, plan: RNSMergePlan, order=None) -> np.ndarray:
    """RNS polynomial multiplication over numpy (batch, N) arrays — the HE
    evaluation workload: row r a residue polynomial modulo
    (q_{mod_idx[r]}, X^N +/- 1), with the cyclic schedule or `order` (as
    rns_pointwise_mult validates it)."""
    x = np.asarray(x)
    mod_idx = _order_mod_idx(x.shape[0], plan, order)
    xl = to_lanes(x, plan.is64, plan.device)
    yl = to_lanes(np.asarray(y), plan.is64, plan.device)
    return from_lanes(rns_polymul_lanes(xl, yl, plan, mod_idx), plan.is64)
