"""RNS (multi-modulus) 4-step NTT in PyTorch — GPU_4STEP_NTT RNS parity.

The port of the JAX package's ops/fourstep_rns.py (the reference's RNS
overload, ntt_4step.cu:2293-2765): row b of a (batch, N) batch is
transformed under modulus mod_idx[b].  The calling conventions are
ops/fourstep.py's: the `_lanes` entries take input pre-transposed (n2,
n1) (forward) or pre-permuted by intt_first_transpose (inverse) and omit
the outer transposes; the `_full` entries bundle them.

`RNSFourStepPlan` keeps one FourStepPlan per modulus.  Route
(`_kernel_route`, the counterpart of the JAX `_mxu_rns_route`): u64,
logn 14-23 (the JAX gate), with hopper_fourstep.covers true for every
member, runs K14 and its rows (hopper_rns.py), through the kernels'
plain versions on a CPU tensor.  Everything else takes the engine, as
does `rns_fourstep_intt_lanes(scale=False)`: each modulus's rows through
that member's single-modulus engine (fourstep.py), bit-exact with the
JAX package's per-row gathers.  Each member builds its (n1, n2) W tables
at its first engine run (FourStepPlan.w_tables), so a plan on the
kernel route holds none: at 2^23 with a ladder of 8 they would be 2 GiB.
u32 ladders run the engine, on the card too, as the JAX package runs
them on XLA.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..params.fourstep import NTTParameters4Step
from . import hopper_fourstep as hf
from . import hopper_rns as hr
from .fourstep import FourStepPlan, _engine, transpose_lanes
from .rns import checked_schedule, per_modulus, schedule_memo


@dataclass(frozen=True, eq=False)
class RNSFourStepPlan:
    """Per-modulus 4-step plans of one shape (logn, n1 x n2, word size)."""

    logn: int
    n1: int
    n2: int
    is64: bool
    qs: tuple
    members: tuple  # FourStepPlans
    device: torch.device
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # lazily built: "kernel" (hopper_rns' K14 plan), "schedules" (device copies,
    # rns.schedule_memo)
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def mod_count(self) -> int:
        return len(self.qs)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @staticmethod
    def from_params(params: Sequence[NTTParameters4Step], device=None) -> "RNSFourStepPlan":
        """The plan of a prime ladder; members must share logn, n1 x n2
        and dtype (ValueError otherwise, as in the JAX package).  `device`
        defaults to the first CUDA card (NTTDeviceError without one);
        device="cpu" runs on the host.  The parameters' W tables are not
        read."""
        from ..common.device import default_device

        p0 = params[0]
        for p in params:
            if (p.logn, p.n1, p.n2, p.dtype) != (p0.logn, p0.n1, p0.n2, p0.dtype):
                raise ValueError("RNS 4-step members must share logn, n1 x n2, and dtype")
        device = torch.device(device) if device is not None else default_device()
        return RNSFourStepPlan._of([FourStepPlan.from_params(p, device=device) for p in params],
                                   device)

    @staticmethod
    def from_arrays(qs, logn: int, n1: int, n2: int, polys, roots, iroots, n_invs, n1_fwd,
                    n2_fwd, n1_inv, n2_inv, w_fwd=None, w_inv=None, device=None,
                    dtype=np.uint64) -> "RNSFourStepPlan":
        """Plan from plain numbers and numpy tables — the converter that
        carries a plan across from the JAX package: one q, reduction
        polynomial (or one for all), root pair and n_inv per modulus, the
        stacked (mod_count, n1 / 2) and (mod_count, n2 / 2) bit-reversed
        tables of the JAX RNSFourStepPlan (`u64_to_numpy` of its pairs for
        u64, its uint32 arrays for u32) and, optionally, its stacked
        (mod_count, n1, n2) W tables.  `device` as in from_params."""
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        if not isinstance(polys, (list, tuple)):
            polys = [polys] * len(qs)

        def row(tables, i):
            return None if tables is None else np.asarray(tables)[i]

        return RNSFourStepPlan._of([
            FourStepPlan.from_arrays(q, logn, n1, n2, polys[i], roots[i], iroots[i], n_invs[i],
                                     row(n1_fwd, i), row(n2_fwd, i), row(n1_inv, i),
                                     row(n2_inv, i), row(w_fwd, i), row(w_inv, i),
                                     device=device, dtype=dtype)
            for i, q in enumerate(qs)], device)

    @staticmethod
    def _of(members, device) -> "RNSFourStepPlan":
        p0 = members[0]
        return RNSFourStepPlan(logn=p0.logn, n1=p0.n1, n2=p0.n2, is64=p0.is64,
                               qs=tuple(m.q for m in members), members=tuple(members),
                               device=device)

    def to(self, device) -> "RNSFourStepPlan":
        """This plan with its tables on `device` (copies are cached; a
        built K14 plan moves with it)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        if device not in self._moved:
            moved = RNSFourStepPlan._of([m.to(device) for m in self.members], device)
            if "kernel" in self._lazy:
                moved._lazy["kernel"] = self._lazy["kernel"].to(device)
            self._moved[device] = moved
        return self._moved[device]


def covers(plan: RNSFourStepPlan) -> bool:
    """Plans the RNS 4-step route sends to K14 (`hopper_rns.K14.routes`:
    u64, logn 14-23), every member covered by the single-modulus 4-step
    kernels (q < 2^62, a genuine root, rows with a kernel)."""
    return (hr.K14.covers(plan.is64, max(plan.qs), plan.logn)
            and all(hf.covers(m) for m in plan.members))


def _kernel_route(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx, inverse: bool):
    if not covers(plan):
        return None
    x2 = x.reshape(-1, plan.n).contiguous()
    key = (str(x.device), np.asarray(mod_idx, dtype=np.int64).tobytes())
    midx = schedule_memo(plan, "schedules", key, lambda: torch.from_numpy(
        np.asarray(mod_idx, dtype=np.int32)).to(x.device))
    return hr.rns_fourstep(x2, hr.fourstep_plan(plan), midx, inverse).reshape(x.shape)


def _transform(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx, inverse: bool,
               scale: bool = True) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"the RNS entries take a (batch, N) tensor, got {tuple(x.shape)}")
    plan = plan.to(x.device)
    mod_idx = checked_schedule(mod_idx, plan.mod_count, x.shape[0])
    routed = _kernel_route(x, plan, mod_idx, inverse) if scale else None
    if routed is not None:
        return routed
    return per_modulus(lambda v, member: _engine(v, member, inverse, scale), plan.members,
                       mod_idx, x)


def rns_fourstep_ntt_lanes(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx) -> torch.Tensor:
    """Forward RNS 4-step on (batch, N) lanes; row b uses modulus
    mod_idx[b].  Input pre-transposed (n2, n1) flat, output (n1, n2)
    flat (GPU_4STEP_NTT convention)."""
    return _transform(x, plan, mod_idx, False)


def rns_fourstep_intt_lanes(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx,
                            scale: bool = True) -> torch.Tensor:
    """Inverse RNS 4-step; input pre-permuted by intt_first_transpose,
    each row's n^-1 applied last (or not at all with scale=False, which
    takes the engine)."""
    return _transform(x, plan, mod_idx, True, scale)


def rns_fourstep_ntt_full(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx) -> torch.Tensor:
    """The whole forward pipeline with both caller-side transposes; row
    b equals NTT_4STEP_CPU::ntt under modulus mod_idx[b]."""
    y = rns_fourstep_ntt_lanes(transpose_lanes(x, plan.n1, plan.n2), plan, mod_idx)
    return transpose_lanes(y, plan.n1, plan.n2)


def rns_fourstep_intt_full(x: torch.Tensor, plan: RNSFourStepPlan, mod_idx) -> torch.Tensor:
    """The whole inverse pipeline with the intt_first_transpose
    permutation (the transpose of the (n2, n1) view, as fourstep_intt_full
    applies it) and the final transpose; row b equals
    NTT_4STEP_CPU::intt."""
    y = rns_fourstep_intt_lanes(transpose_lanes(x, plan.n2, plan.n1), plan, mod_idx)
    return transpose_lanes(y, plan.n1, plan.n2)
