"""Polynomial multiplication model — the framework's flagship pipeline.

The reference ships this pipeline only as example code
(test_cpu_merge_ntt.cu:69-101: NTT -> pointwise mult -> INTT ==
schoolbook).  `PolynomialMultiplier` is the port of the JAX package's
single-device model as an `nn.Module`: the plan's twiddle tables are
registered buffers (so `.to(device)` moves them), `forward(a, b)` takes
lane tensors, and calling it on numpy arrays keeps the JAX signature.
`device` defaults to the first CUDA card (NTTDeviceError without one);
pass device="cpu" to run on the host.  u64 params reach the kernels of
hopper_merge.py (logn 12-17) and hopper_merge_large.py (18-28), u32
params those of hopper_merge32.py, all through polymul_lanes.  A
big-ring plan holds no N-entry table (MergePlan.bigring): its module
registers an empty `anchor` buffer instead, whose device the plan
follows.  `RNSPolynomialMultiplier` is the port of the JAX package's
RNS model, on the RNS route of dispatch (rns_polymul_lanes).
`DistPolynomialMultiplier` and `DistRNSPolynomialMultiplier` are the
distributed models (JAX :101-166) over parallel/: two distributed
4-step forwards, the pointwise product, the distributed inverse, on
rank-local (B/dp, n1, n2/sp) blocks; X^N - 1 only, as there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.dispatch import _rns_mod_idx, polymul_lanes, rns_polymul_lanes
from ..ops.merge_ntt import MergePlan, from_lanes, to_lanes
from ..ops.rns import RNSMergePlan
from ..params.merge import NTTParameters, ReductionPolynomial

_TABLES = ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup")


class PolynomialMultiplier(torch.nn.Module):
    """c = a * b mod (q, X^N +/- 1) via merge NTT (single device)."""

    def __init__(self, params: NTTParameters, device=None):
        super().__init__()
        self.params = params
        self._plan = MergePlan.from_params(params, device=device)
        if self._plan.fwd_table is None:
            self.register_buffer("anchor", torch.empty(0, dtype=torch.int64,
                                                       device=self._plan.device))
            return
        for name in _TABLES:
            self.register_buffer(name, getattr(self._plan, name))

    @property
    def plan(self) -> MergePlan:
        """The plan over this module's buffers, wherever they now live."""
        if self._plan.fwd_table is None:
            if self.anchor.device != self._plan.device:
                self._plan = self._plan.to(self.anchor.device)
        elif self.fwd_table is not self._plan.fwd_table:
            self._plan = dataclasses.replace(
                self._plan, _moved={}, _lazy={}, device=self.fwd_table.device,
                **{n: getattr(self, n) for n in _TABLES})
        return self._plan

    def step_lanes(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The lane-tensor pipeline, polymul_lanes on this module's plan
        (the JAX model's step_lanes, gpuntt_tpu/models/polymul.py:48-55)."""
        return polymul_lanes(a, b, self.plan)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.step_lanes(a, b)

    def __call__(self, a, b):
        if isinstance(a, torch.Tensor):
            return super().__call__(a, b)
        plan = self.plan
        out = super().__call__(to_lanes(np.asarray(a), plan.is64, plan.device),
                               to_lanes(np.asarray(b), plan.is64, plan.device))
        return from_lanes(out, plan.is64)


_STACKS = ("fwd_tables", "fwd_shoup", "inv_tables", "inv_shoup", "consts")


class RNSPolynomialMultiplier(torch.nn.Module):
    """Residue-wise products over an RNS prime ladder — the HE evaluation
    workload the RNS engines exist for (gpuntt_tpu/models/polymul.py:67).

    Operands are (mod_count, N) residue stacks (row i modulo the i-th
    member's q_i) or (..., mod_count, N) batches of them; the cyclic
    modulus schedule of the RNS dispatch (q_index = b % mod_count)
    matches that row order, so the residue batches ride the RNS kernels
    (u64 with q < 2^62: K12 at logn 12-17, K13 at 18-23; u32 with
    q < 2^30: the stacked u32 kernels at 8-25).
    `crt_reconstruct` lifts results back to Z_{prod q_i}.  The plan's
    stacked tables and constants are registered buffers, so `.to(device)`
    moves them; a big-ring ladder holds no stacked table and registers
    `consts` alone.  `forward(a, b)` takes lane tensors; calling the
    module on numpy arrays keeps the JAX signature."""

    def __init__(self, members, device=None):
        super().__init__()
        self._plan = RNSMergePlan.from_params(members, device=device)
        self.mod_count = self._plan.mod_count
        self.qs = self._plan.qs
        for name in _STACKS:
            if getattr(self._plan, name) is not None:
                self.register_buffer(name, getattr(self._plan, name))

    @property
    def plan(self) -> RNSMergePlan:
        """The plan over this module's buffers, wherever they now live."""
        plan = self._plan
        if self.consts is plan.consts:
            return plan
        if plan.fwd_tables is None:  # a big-ring ladder: its K13 plan moves along
            self._plan = plan.to(self.consts.device)
        else:
            self._plan = RNSMergePlan._build(
                plan.logn, plan.reduction_poly, plan.is64, plan.members,
                {n: getattr(self, n) for n in _STACKS[:4]}, self.consts, self.consts.device,
                plan.params)
        return self._plan

    def _check(self, a_shape, b_shape) -> None:
        if len(a_shape) < 2 or a_shape != b_shape or a_shape[-2] != self.mod_count:
            raise ValueError(
                f"operands must be (..., {self.mod_count}, N) residue stacks, got "
                f"{tuple(a_shape)} and {tuple(b_shape)}")

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        self._check(a.shape, b.shape)
        n = a.shape[-1]
        a2, b2 = a.reshape(-1, n), b.reshape(-1, n)
        out = rns_polymul_lanes(a2, b2, self.plan, _rns_mod_idx(a2.shape[0], self.mod_count))
        return out.reshape(a.shape)

    def __call__(self, a, b):
        if isinstance(a, torch.Tensor):
            return super().__call__(a, b)
        a, b = np.asarray(a), np.asarray(b)
        self._check(a.shape, b.shape)
        plan = self.plan
        out = super().__call__(to_lanes(a, plan.is64, plan.device),
                               to_lanes(b, plan.is64, plan.device))
        return from_lanes(out, plan.is64)


def _cyclic_only(params) -> None:
    for p in params:
        if p.poly_reduction != ReductionPolynomial.X_N_minus:
            raise ValueError("4-step polymul diagonalises cyclic convolution (X_N_minus) only")


def _mesh_device(mesh, device):
    """The plan's device: `device`, or the host for a cpu mesh, or the card."""
    if device is None and mesh.device_type == "cpu":
        return torch.device("cpu")
    return device


class DistPolynomialMultiplier(torch.nn.Module):
    """c = a * b mod (q, X^N - 1) via the distributed 4-step NTT.

    Operands are this rank's (B/dp, n1, n2/sp) blocks (mesh.BLOCKS), and
    the product comes back in the same layout; all cross-rank traffic is
    the all_to_alls inside the transforms.  The plan lives on the mesh's
    device (or `device`); an empty `anchor` buffer carries it along
    `.to(device)`."""

    def __init__(self, params, mesh, pipeline_chunks: int = 1, device=None):
        super().__init__()
        from ..parallel.fourstep_dist import DistFourStepPlan

        _cyclic_only([params])
        self.params = params
        self.mesh = mesh
        self.pipeline_chunks = pipeline_chunks
        self._dplan = DistFourStepPlan.from_params(params, device=_mesh_device(mesh, device))
        self.register_buffer("anchor", torch.empty(0, dtype=torch.int64,
                                                   device=self._dplan.device))

    @property
    def dplan(self):
        return self._dplan.to(self.anchor.device)

    def step_lanes(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The full step: two forwards, the pointwise product, the inverse."""
        from ..ops.dispatch import pointwise_mult_lanes
        from ..parallel.fourstep_dist import dist_fourstep_intt, dist_fourstep_ntt

        d, pc = self.dplan, self.pipeline_chunks
        fa = dist_fourstep_ntt(a, d, self.mesh, pipeline_chunks=pc)
        fb = dist_fourstep_ntt(b, d, self.mesh, pipeline_chunks=pc)
        fc = pointwise_mult_lanes(fa, fb, d.base)
        return dist_fourstep_intt(fc, d, self.mesh, pipeline_chunks=pc)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.step_lanes(a, b)


class DistRNSPolynomialMultiplier(torch.nn.Module):
    """Residue-ladder products over a device mesh: operands are rank-local
    (B/dp, n1, n2/sp) blocks whose rows cycle through the ladder under
    `mod_idx` (row b modulo q_{mod_idx[b]}, the schedule read as
    dist_rns_fourstep_ntt reads it); the per-row Barrett product is local.
    X^N - 1 members only."""

    def __init__(self, members, mesh, device=None):
        super().__init__()
        from ..parallel.fourstep_rns_dist import DistRNSFourStepPlan

        _cyclic_only(members)
        self.mesh = mesh
        self._dplan = DistRNSFourStepPlan.from_members(members,
                                                       device=_mesh_device(mesh, device))
        self.mod_count = self._dplan.mod_count
        self.register_buffer("anchor", torch.empty(0, dtype=torch.int64,
                                                   device=self._dplan.device))

    @property
    def dplan(self):
        return self._dplan.to(self.anchor.device)

    def step_lanes(self, a: torch.Tensor, b: torch.Tensor, mod_idx) -> torch.Tensor:
        from ..ops.dispatch import rns_pointwise_mult_lanes
        from ..parallel.fourstep_rns_dist import (dist_rns_fourstep_intt,
                                                  dist_rns_fourstep_ntt, local_schedule)

        d = self.dplan
        mi = local_schedule(mod_idx, a.shape[0], self.mesh, self.mod_count)
        fa = dist_rns_fourstep_ntt(a, d, self.mesh, mi)
        fb = dist_rns_fourstep_ntt(b, d, self.mesh, mi)
        fc = rns_pointwise_mult_lanes(fa, fb, d.base, mi)
        return dist_rns_fourstep_intt(fc, d, self.mesh, mi)

    def forward(self, a: torch.Tensor, b: torch.Tensor, mod_idx) -> torch.Tensor:
        return self.step_lanes(a, b, mod_idx)
