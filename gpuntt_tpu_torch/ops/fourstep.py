"""4-step (matrix) NTT entries in PyTorch — GPU_4STEP_NTT parity.

The port of the JAX package's ops/fourstep.py, the reference's 4-step
pipeline (ntt_4step.cu:36-3260):

  [transpose]            caller-side (GPU_Transpose, ntt_4step.cu:58-66)
  [n1-NTT on columns]    (FourStepForwardCoreT1..T4 :68-745)
  [transpose + W]        (fused into the row-NTT load, :1049-1058)
  [n2-NTT on rows]       (FourStepPartialForwardCore :746-1171)
  [transpose]            caller-side

`fourstep_ntt_lanes` / `fourstep_intt_lanes` keep the reference's
calling convention (the first and last transposes are the caller's;
the inverse takes input pre-permuted by `intt_first_transpose` and
folds n^-1 into its last step); `fourstep_ntt_full` /
`fourstep_intt_full` bundle the permutations, which are plain torch
relayouts outside any kernel, as they are XLA relayouts in the JAX
package.  Any leading shape is one batch of (batch, N).

Route (`_route`, the counterpart of the JAX `_mxu_route`, and the
entries' ntt.route span, common/tracing.py): a plan that
hopper_fourstep.covers (genuine root, u64 q < 2^62 or u32 q < 2^30,
logn 12-24, n1 <= 512, rows with a kernel) runs the hand-written
kernels — the column phase (K9, K11) and the rows (K10, K11's row twin,
or the merge kernels for rows above 512 words) — through
hopper_fourstep's composition; on a CPU tensor the same composition
runs the kernels' plain versions.  Everything else takes the engine:
the torch stage sweeps of merge_ntt.py along the last axis with the
cyclic (X^N - 1) indexing for both polynomials, as the reference's
core_ntt, and the (n1, n2) W tables, which the plan builds only when
the engine first runs (`w_tables`), as MergePlan.with_tables does.  So
does `fourstep_intt_lanes(..., scale=False)`, as in the JAX package:
the kernels fold n^-1 into the rows.  u32 routes from logn 12, not the
JAX package's 17 (a v5e timing, fourstep.py:163-169).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..common import tracing
from ..params.bitrev import bitrev_permute, bitreverse, bitreverse_indices
from ..params.fourstep import NTTParameters4Step
from ..params.merge import ReductionPolynomial
from . import barrett as bo
from . import hopper_fourstep as hf
from .hopper_merge_large import pows
from .limb import from_numpy_u64, signed
from .merge_ntt import ButterflyOps, butterfly_ops, ct_stages, gs_stages

_TABLES = ("n1_fwd", "n1_fwd_sh", "n2_fwd", "n2_fwd_sh",
           "n1_inv", "n1_inv_sh", "n2_inv", "n2_inv_sh")


@dataclass(frozen=True, eq=False)
class FourStepPlan:
    """Tables for the 4-step transform (NTTParameters4Step,
    nttparameters.cu:191-225): the bit-reversed half-length n1 and n2
    tables with their Shoup companions as int64 tensors on `device`,
    and the numbers.  `root`/`iroot` are the full-size root pair (omega
    for X^N - 1, psi for X^N + 1) from which the kernels' plan and the
    engine's W tables are built at first use; `params` is the
    originating NTTParameters4Step, if any."""

    logn: int
    n1: int
    n2: int
    q: int
    is64: bool
    bit: int
    mu: int
    poly: ReductionPolynomial
    root: int
    iroot: int
    n_inv: int
    n_inv_shoup: int
    n1_fwd: torch.Tensor
    n1_fwd_sh: torch.Tensor
    n2_fwd: torch.Tensor
    n2_fwd_sh: torch.Tensor
    n1_inv: torch.Tensor
    n1_inv_sh: torch.Tensor
    n2_inv: torch.Tensor
    n2_inv_sh: torch.Tensor
    device: torch.device
    params: Any = None
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # lazily built: "w" (the engine's W tables), "kernel" (hopper_fourstep)
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @staticmethod
    def from_params(p: NTTParameters4Step, device=None) -> "FourStepPlan":
        """The plan of `p`.  `device` defaults to the first CUDA card;
        without one that raises NTTDeviceError (device="cpu" runs on the
        host).  The W tables of `p` are not read."""
        return FourStepPlan.from_arrays(
            p.modulus.value, p.logn, p.n1, p.n2, p.poly_reduction, p.root_of_unity,
            p.inverse_root_of_unity, p.n_inv,
            bitrev_permute(p.n1_based_root_of_unity_table),
            bitrev_permute(p.n2_based_root_of_unity_table),
            bitrev_permute(p.n1_based_inverse_root_of_unity_table),
            bitrev_permute(p.n2_based_inverse_root_of_unity_table),
            device=device, dtype=p.dtype, params=p)

    @staticmethod
    def from_arrays(q: int, logn: int, n1: int, n2: int, poly, root: int, iroot: int,
                    n_inv: int, n1_fwd, n2_fwd, n1_inv, n2_inv, w_fwd=None, w_inv=None,
                    device=None, dtype=np.uint64, params=None) -> "FourStepPlan":
        """Plan from plain numbers and numpy tables — the converter that
        carries a plan across from the JAX package.  The four small
        tables are in bit-reversed order, as the JAX FourStepPlan holds
        them (`u64_to_numpy` of its pairs for u64, its uint32 arrays for
        u32); `w_fwd`/`w_inv`, its (n1, n2) W tables, are optional (the
        engine builds its own from the root pair otherwise); `poly` is a
        ReductionPolynomial of either package, or its value.  The Shoup
        companions are derived here.  `device` as in from_params."""
        from ..common.device import default_device
        from ..arith.modulus import Modulus

        device = torch.device(device) if device is not None else default_device()
        is64 = np.dtype(dtype) == np.uint64
        word = 64 if is64 else 32
        m = Modulus(int(q), bits=word)
        if n1 * n2 != 1 << logn or n1 & (n1 - 1) or n2 & (n2 - 1):
            raise ValueError(f"dims {n1} x {n2} do not split 2^{logn}")

        def dev(table):
            return from_numpy_u64(np.asarray(table, dtype=np.uint64), device)

        def pair(table):
            table = np.asarray(table, dtype=np.uint64)
            return dev(table), dev(bo.shoup_companion(table, m.value, word))

        tabs = {}
        for name, table, size in (("n1_fwd", n1_fwd, n1), ("n2_fwd", n2_fwd, n2),
                                  ("n1_inv", n1_inv, n1), ("n2_inv", n2_inv, n2)):
            if len(table) != size // 2:
                raise ValueError(f"{name} has {len(table)} entries, not {size // 2}")
            tabs[name], tabs[name + "_sh"] = pair(table)
        plan = FourStepPlan(
            logn=int(logn), n1=int(n1), n2=int(n2), q=m.value, is64=is64, bit=m.bit,
            mu=m.mu, poly=ReductionPolynomial(getattr(poly, "value", poly)),
            root=int(root), iroot=int(iroot), n_inv=int(n_inv),
            n_inv_shoup=(int(n_inv) << word) // m.value, device=device, params=params,
            **tabs)
        if w_fwd is not None and w_inv is not None:
            plan._lazy["w"] = (*pair(np.reshape(w_fwd, (n1, n2))),
                               *pair(np.reshape(w_inv, (n1, n2))))
        return plan

    def w_tables(self) -> tuple[torch.Tensor, ...]:
        """(w_fwd, w_fwd_shoup, w_inv, w_inv_shoup), each (n1, n2): the
        engine's W tables, built on first call and cached.  Forward
        W[i, j] = root^(br(i) j), inverse W[i, j] = iroot^(i br(j))
        (nttparameters.cu:382-396, :430-444).  The kernels never read
        them: at 2^24 the four are 512 MiB."""
        if "w" not in self._lazy:
            log1, log2 = self.n1.bit_length() - 1, self.n2.bit_length() - 1
            q, word = self.q, 64 if self.is64 else 32
            brev = bitreverse_indices(log2)
            wf = np.stack([pows(pow(self.root, bitreverse(i, log1), q), q, self.n2)
                           for i in range(self.n1)])
            wi = np.stack([pows(pow(self.iroot, i, q), q, self.n2)[brev]
                           for i in range(self.n1)])
            self._lazy["w"] = tuple(
                from_numpy_u64(t, self.device)
                for w in (wf, wi) for t in (w, bo.shoup_companion(w, q, word)))
        return self._lazy["w"]

    def to(self, device) -> "FourStepPlan":
        """This plan with its tables on `device` (copies are cached; built
        W tables and kernel plans move with it).  Counted under
        tracing's plan_to.hit / plan_to.move."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            tracing.outcome("plan_to.hit", "plan", "hit")
            return self
        if device in self._moved:
            tracing.outcome("plan_to.hit", "plan", "hit")
            return self._moved[device]
        tracing.outcome("plan_to.move", "plan", "move")
        lazy = {}
        if "w" in self._lazy:
            lazy["w"] = tuple(t.to(device) for t in self._lazy["w"])
        if "kernel" in self._lazy:
            lazy["kernel"] = self._lazy["kernel"].to(device)
        self._moved[device] = dataclasses.replace(
            self, _moved={}, _lazy=lazy, device=device,
            **{f: getattr(self, f).to(device) for f in _TABLES})
        return self._moved[device]

    def ops(self) -> ButterflyOps:
        return butterfly_ops(self.q, self.is64)


def transpose_lanes(x: torch.Tensor, row: int, col: int) -> torch.Tensor:
    """GPU_Transpose equivalent (ntt_4step.cu:36-66): read the last axis
    as a (row, col) matrix and return its transpose, flattened."""
    lead = x.shape[:-1]
    return x.reshape(lead + (row, col)).transpose(-1, -2).reshape(lead + (row * col,))


def _route(x: torch.Tensor, plan: FourStepPlan, kernels: bool):
    """The ntt.route span of the entries: the plan on x's device and, where
    `kernels` and hopper_fourstep covers the plan, the kernels' plan (None
    takes the engine)."""
    span = tracing.begin(tracing.ROUTE)
    try:
        plan = plan.to(x.device)
        kp = hf.kernel_plan(plan) if kernels and hf.covers(plan) else None
        if span:
            span.attrs["path"] = "engine" if kp is None else "hopper-fourstep"
    finally:
        if span:
            span.end()
    return plan, kp


def _kernel_route(x: torch.Tensor, plan: FourStepPlan, kp, inverse: bool):
    """The transform through hopper_fourstep's kernels (their plain
    versions on a CPU tensor) on the kernels' plan `kp`."""
    y = hf.fourstep(x.reshape(-1, plan.n).contiguous(), kp, inverse)
    return y.reshape(x.shape)


def _engine(x: torch.Tensor, plan: FourStepPlan, inverse: bool, scale: bool):
    ops = plan.ops()
    w_fwd, w_fwd_sh, w_inv, w_inv_sh = plan.w_tables()
    log1, log2 = plan.n1.bit_length() - 1, plan.n2.bit_length() - 1
    lead = x.shape[:-1]
    y = x.reshape(lead + (plan.n2, plan.n1))
    if inverse:
        y = gs_stages(y, plan.n1_inv, plan.n1_inv_sh, ops, log1, False).transpose(-1, -2)
        y = ops.mulc(y, w_inv, w_inv_sh)
        y = gs_stages(y, plan.n2_inv, plan.n2_inv_sh, ops, log2, False)
        if scale:
            y = ops.mulc(y, plan.n_inv, signed(plan.n_inv_shoup))
    else:
        y = ct_stages(y, plan.n1_fwd, plan.n1_fwd_sh, ops, log1, False).transpose(-1, -2)
        y = ops.mulc(y, w_fwd, w_fwd_sh)
        y = ct_stages(y, plan.n2_fwd, plan.n2_fwd_sh, ops, log2, False)
    return y.reshape(lead + (plan.n,))


@tracing.entry
def fourstep_ntt_lanes(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """GPU_4STEP_NTT(FORWARD) parity: input pre-transposed (n2, n1)
    flattened, output (n1, n2) flattened before the final transpose
    (ntt_4step.cu:2303-2533)."""
    plan, kp = _route(x, plan, True)
    return _engine(x, plan, False, True) if kp is None else _kernel_route(x, plan, kp, False)


@tracing.entry
def fourstep_intt_lanes(x: torch.Tensor, plan: FourStepPlan,
                        scale: bool = True) -> torch.Tensor:
    """GPU_4STEP_NTT(INVERSE) parity: input pre-permuted by
    intt_first_transpose (test_4step_intt.cu:83-88), output (n1, n2)
    flattened before the final transpose; n^-1 last
    (FourStepPartialInverseCore, ntt_4step.cu:1875-2015), or not at all
    with scale=False, which takes the engine."""
    plan, kp = _route(x, plan, scale)
    return _engine(x, plan, True, scale) if kp is None else _kernel_route(x, plan, kp, True)


def fourstep_ntt_full(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """The whole forward pipeline with both caller-side transposes; equals
    NTT_4STEP_CPU::ntt (ntt_4step_cpu.cu:33-68)."""
    y = fourstep_ntt_lanes(transpose_lanes(x, plan.n1, plan.n2), plan)
    return transpose_lanes(y, plan.n1, plan.n2)


def fourstep_intt_full(x: torch.Tensor, plan: FourStepPlan) -> torch.Tensor:
    """The whole inverse pipeline with the intt_first_transpose
    permutation and the final transpose; equals NTT_4STEP_CPU::intt.
    The permutation, a gather by intt_input_indices(n1, n2) in the JAX
    package, is the transpose of the (n2, n1) view: element i * n2 + j
    reads input j * n1 + i."""
    y = fourstep_intt_lanes(transpose_lanes(x, plan.n2, plan.n1), plan)
    return transpose_lanes(y, plan.n1, plan.n2)
