"""RNS (multi-modulus) plan and engine in PyTorch.

The port of the JAX package's ops/rns.py, the reference's RNS kernel
families (plain RNS, ntt.cu:2560-3059; Modulus_Ordered, :3103-3768;
Poly_Ordered, :3782-4459): row b of a (batch, N) batch is transformed
under modulus mod_idx[b] of a prime ladder.

`RNSMergePlan` stacks its members' bit-reversed tables and Shoup
companions on a leading (mod_count,) axis, as the JAX plan does, and
keeps each member as a MergePlan whose tables are views of its row of
the stack.  `consts` holds each member's numbers as (mod_count, 6)
words — q, floor(2^word / q), n_inv, its Shoup companion, bit, mu —
which the K12 kernels (hopper_rns.py) read by modulus index.  A plan
whose members are big rings (MergePlan.bigring: u64, q < 2^62, a
genuine root, logn 18-28) holds no stacked tables, as its members hold
none: the K13 route builds its own plan from exponent algebra, and the
engine builds each member's tables at its first run.  At 2^23 with a
ladder of 8 the stacked tables would be 2 GiB.

`rns_ntt_lanes` / `rns_intt_lanes` are the engine: every transform is
row-independent, so each modulus's rows run through that member's plan
on the butterfly engine of merge_ntt.py and are scattered back.  That is
bit-exact with the JAX package's gather formulation, which runs the same
stages with per-row twiddles.  A schedule entry outside [0, mod_count)
is read as jnp indexing reads it (`schedule_index`), and a schedule of
one entry serves every row (`checked_schedule`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..common.errors import NTTError
from ..params.merge import NTTParameters, ReductionPolynomial
from .limb import signed
from .merge_ntt import MergePlan, merge_intt_lanes, merge_ntt_lanes

_TABLES = ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup")
_STACKS = ("fwd_tables", "fwd_shoup", "inv_tables", "inv_shoup")


class NTTScheduleError(NTTError, TypeError, ValueError):
    """An RNS modulus schedule whose length fits neither the batch nor one
    entry for every row.  The JAX package's entries fail there while
    broadcasting, with a TypeError in the transforms and a ValueError in
    the pointwise product; this one error is both."""


def schedule_index(mod_idx, mod_count: int) -> np.ndarray:
    """A modulus schedule as the JAX engine's gathers read it (jnp
    indexing): a negative entry wraps once, then every entry clamps into
    [0, mod_count).  So [5, -1, 0] is [2, 2, 0] at mod_count 3."""
    m = np.asarray(mod_idx, dtype=np.int64).reshape(-1)
    return np.clip(np.where(m < 0, m + mod_count, m), 0, mod_count - 1)


@dataclass(frozen=True, eq=False)
class RNSMergePlan:
    """Per-modulus merge plans of one ring shape, their tables stacked
    (see the module note).  `params` are the originating NTTParameters,
    if any."""

    logn: int
    reduction_poly: ReductionPolynomial
    is64: bool
    qs: tuple
    members: tuple  # MergePlans; their tables are views of the stacks
    fwd_tables: torch.Tensor | None  # (mod_count, size), bit-reversed
    fwd_shoup: torch.Tensor | None
    inv_tables: torch.Tensor | None
    inv_shoup: torch.Tensor | None
    consts: torch.Tensor  # (mod_count, 6) int64
    device: torch.device
    params: tuple | None = None
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # lazily built: "large" (hopper_rns' K13 plan), "schedules" (device copies)
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def mod_count(self) -> int:
        return len(self.qs)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def xnp(self) -> bool:
        return self.reduction_poly == ReductionPolynomial.X_N_plus

    @property
    def genuine_root(self) -> bool:
        """Every member's factors are a genuine root pair (what the
        kernels' route asks, as MergePlan.genuine_root)."""
        return all(m.genuine_root for m in self.members)

    @staticmethod
    def from_params(params: Sequence[NTTParameters], device=None) -> "RNSMergePlan":
        """The plan of a prime ladder.  Members must share logn, the
        reduction polynomial and the word size (ValueError otherwise, as
        in the JAX package).  `device` defaults to the first CUDA card;
        without one that raises NTTDeviceError (device="cpu" runs on the
        host)."""
        from ..common.device import default_device

        p0 = params[0]
        for p in params:
            if p.logn != p0.logn or p.poly_reduction != p0.poly_reduction:
                raise ValueError("RNS members must share logn and reduction poly")
            if p.dtype != p0.dtype:
                raise ValueError("RNS members must share dtype")
        device = torch.device(device) if device is not None else default_device()
        return RNSMergePlan.from_plans([MergePlan.from_params(p, device=device)
                                        for p in params], params=tuple(params))

    @staticmethod
    def from_arrays(qs, logn: int, poly, roots, iroots, n_invs, fwd_tables=None,
                    inv_tables=None, device=None, dtype=np.uint64) -> "RNSMergePlan":
        """Plan from plain numbers and numpy tables — the converter that
        carries a plan across from the JAX package: `qs`, `roots`,
        `iroots` and `n_invs` one per modulus (the members' root_of_unity,
        inverse_root_of_unity and n_inv), the stacked (mod_count, size)
        bit-reversed tables as the JAX RNSMergePlan holds them
        (`u64_to_numpy(plan.fwd_tables)` for u64, its uint32 arrays for
        u32), or None for a plan without them.  `poly` is a
        ReductionPolynomial of either package, or its value.  The Shoup
        companions are derived here; `device` as in from_params."""
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        members = []
        for i, q in enumerate(qs):
            fwd = None if fwd_tables is None else np.asarray(fwd_tables)[i]
            inv = None if inv_tables is None else np.asarray(inv_tables)[i]
            members.append(MergePlan.from_arrays(q, logn, poly, roots[i], iroots[i],
                                                 n_invs[i], fwd, inv, device=device,
                                                 dtype=dtype))
        return RNSMergePlan.from_plans(members)

    @staticmethod
    def from_plans(plans: Sequence[MergePlan], params=None) -> "RNSMergePlan":
        """The stack of MergePlans of one shape (logn, polynomial, word
        size, device); each member becomes a view of its row."""
        p0 = plans[0]
        for p in plans:
            if ((p.logn, p.reduction_poly, p.is64, p.device)
                    != (p0.logn, p0.reduction_poly, p0.is64, p0.device)):
                raise ValueError("RNS members must share logn, reduction poly, dtype "
                                 "and device")
        word = 64 if p0.is64 else 32
        consts = torch.tensor(
            [[signed(v) for v in (p.q, (1 << word) // p.q, p.n_inv, p.n_inv_shoup, p.bit,
                                  p.mu)] for p in plans], dtype=torch.int64,
            device=p0.device)
        if any(p.fwd_table is None for p in plans):
            stacks = dict.fromkeys(_STACKS)
        else:
            stacks = {s: torch.stack([getattr(p, t) for p in plans])
                      for s, t in zip(_STACKS, _TABLES)}
        return RNSMergePlan._build(p0.logn, p0.reduction_poly, p0.is64, plans, stacks,
                                   consts, p0.device, params)

    @staticmethod
    def _build(logn, poly, is64, plans, stacks, consts, device, params) -> "RNSMergePlan":
        if stacks["fwd_tables"] is not None:
            plans = [dataclasses.replace(p, device=device, _moved={}, _lazy={},
                                         **{t: stacks[s][i] for s, t in zip(_STACKS, _TABLES)})
                     for i, p in enumerate(plans)]
        return RNSMergePlan(logn=logn, reduction_poly=poly, is64=is64,
                            qs=tuple(p.q for p in plans), members=tuple(plans),
                            consts=consts, device=device, params=params, **stacks)

    def to(self, device) -> "RNSMergePlan":
        """This plan with every table on `device` (copies are cached; a
        built K13 plan moves with it)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        if device not in self._moved:
            stacks = {s: None if getattr(self, s) is None else getattr(self, s).to(device)
                      for s in _STACKS}
            members = self.members
            if stacks["fwd_tables"] is None:
                members = [m.to(device) for m in members]
            moved = RNSMergePlan._build(self.logn, self.reduction_poly, self.is64, members,
                                        stacks, self.consts.to(device), device, self.params)
            if "large" in self._lazy:
                moved._lazy["large"] = self._lazy["large"].to(device)
            self._moved[device] = moved
        return self._moved[device]

    def device_bytes(self) -> int:
        """Bytes of the stacked tables and constants."""
        return sum(t.numel() * t.element_size() for t in
                   (*(getattr(self, s) for s in _STACKS), self.consts) if t is not None)


# ------------------------------------------------------------------ engine


def per_modulus(fn, members, mod_idx, *xs) -> torch.Tensor:
    """fn(*rows, member) on each modulus's rows of the tensors xs (row b
    under members[mod_idx[b]], a numpy or torch schedule of one entry in
    [0, len(members)) per row), scattered back into a new tensor.  A
    schedule that leaves a row unnamed raises NTTScheduleError."""
    if isinstance(mod_idx, torch.Tensor):
        mod_idx = mod_idx.cpu().numpy()
    mod_idx = np.asarray(mod_idx).reshape(-1)
    rows = xs[0].shape[0]
    if len(mod_idx) != rows or (rows and not 0 <= mod_idx.min() <= mod_idx.max()
                                < len(members)):
        raise NTTScheduleError(f"a schedule of {len(mod_idx)} entries in [0, "
                               f"{len(members)}) must name one member for each of "
                               f"{rows} rows, got {mod_idx}")
    out = torch.empty(xs[0].shape, dtype=xs[0].dtype, device=xs[0].device)
    for m, member in enumerate(members):
        sel = np.nonzero(mod_idx == m)[0]
        if sel.size:
            idx = torch.from_numpy(sel).to(xs[0].device)
            out[idx] = fn(*(x[idx] for x in xs), member)
    return out


def checked_schedule(mod_idx, mod_count: int, rows: int) -> np.ndarray:
    """schedule_index of a schedule for `rows` rows: one entry per row,
    or one entry for them all (broadcast over the rows, as the JAX
    engine's gathers broadcast it).  Any other length raises
    NTTScheduleError, where the JAX package fails to broadcast."""
    mod_idx = schedule_index(mod_idx, mod_count)
    if len(mod_idx) == 1:
        return np.repeat(mod_idx, rows)
    if len(mod_idx) != rows:
        raise NTTScheduleError(f"a schedule of {len(mod_idx)} entries for {rows} rows")
    return mod_idx


def rns_ntt_lanes(x: torch.Tensor, plan: RNSMergePlan, mod_idx) -> torch.Tensor:
    """Forward RNS NTT of a (batch, N) lane tensor on the engine; row b
    uses modulus mod_idx[b]."""
    plan = plan.to(x.device)
    return per_modulus(merge_ntt_lanes, plan.members,
                       checked_schedule(mod_idx, plan.mod_count, x.shape[0]), x)


def rns_intt_lanes(x: torch.Tensor, plan: RNSMergePlan, mod_idx,
                   scale: bool = True) -> torch.Tensor:
    """Inverse RNS NTT on the engine (GS butterflies, each row's n^-1
    last, or none with scale=False)."""
    plan = plan.to(x.device)
    return per_modulus(lambda v, member: merge_intt_lanes(v, member, scale), plan.members,
                       checked_schedule(mod_idx, plan.mod_count, x.shape[0]), x)
