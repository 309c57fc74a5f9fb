"""Distributed RNS 4-step NTT — prime-ladder batches over a device mesh.

The port of the JAX package's parallel/fourstep_rns_dist.py: the
n2-sharded distributed 4-step (fourstep_dist.py) over a residue batch,
row b modulo q_{mod_idx[b]}.  Per shard:

  the column (n1-point) NTTs of every row under its modulus,
  the per-row W product (this rank's columns of each member's W),
  one all_to_all_single on the sp group (n2-sharded to n1-sharded),
  the row (n2-point) NTTs.

The local transforms are the stacked RNS transforms of the port
(ntt_rns_lanes / intt_rns_lanes on ladders of n1- and n2-point sub-plans
with n_inv = 1), which route them as ops/fourstep_rns.py's members are
routed: K12 at 2^12-2^17, K13's family above, the stacked u32 kernels,
or the engine (JAX runs u32 ladders on XLA stages).  The W, W^-1 and
n^-1 products are plain torch, each modulus's rows with its member's
tables.  The schedule rides the batch: `mod_idx` names the global
batch's moduli (B entries, as in JAX, of which each rank takes its dp
block), or this rank's rows' (B/dp), or one entry for every row.
Outputs are bit-identical to each row's single-chip 4-step under its
member.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import barrett as bo
from ..ops.dispatch import intt_rns_lanes, ntt_rns_lanes
from ..ops.fourstep_rns import RNSFourStepPlan
from ..ops.limb import from_numpy_u64, signed
from ..ops.rns import RNSMergePlan, checked_schedule, per_modulus, rns_intt_lanes, rns_ntt_lanes
from ..params.merge import ReductionPolynomial
from .fourstep_dist import _numpy, _sub_plan, _use_pallas, _w_columns, check_block, pipelined
from .mesh import axis, sp_group


@dataclass(frozen=True, eq=False)
class DistRNSFourStepPlan:
    """The RNSFourStepPlan (`base`) and the ladders of n1- and n2-point
    sub-plans (`col`, `row`; n_inv = 1) of the local transforms.  Each
    member's W columns are built a rank at a time, at first use
    (`w_local`)."""

    base: RNSFourStepPlan
    col: RNSMergePlan
    row: RNSMergePlan
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # ("w", sp, rank): this rank's stacked W columns; "w_chain": carried W^-1
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def mod_count(self) -> int:
        return self.base.mod_count

    @staticmethod
    def from_members(params, device=None) -> "DistRNSFourStepPlan":
        """The plan of a ladder of NTTParameters4Step (one logn, n1 x n2
        and dtype, as RNSFourStepPlan asks); `device` as there."""
        return DistRNSFourStepPlan._of(RNSFourStepPlan.from_params(params, device=device))

    @staticmethod
    def _of(base: RNSFourStepPlan) -> "DistRNSFourStepPlan":
        return DistRNSFourStepPlan(
            base=base,
            col=RNSMergePlan.from_plans([_sub_plan(m, base.n1) for m in base.members]),
            row=RNSMergePlan.from_plans([_sub_plan(m, base.n2) for m in base.members]))

    @staticmethod
    def from_jax(dplan, device=None) -> "DistRNSFourStepPlan":
        """The port's plan of a JAX DistRNSFourStepPlan, from its stacked
        tables (RNSFourStepPlan.from_arrays' conversion) and its stacked
        chain-inverse W; each member's root pair is read off its W."""
        jb = dplan.base
        n1, n2 = jb.n1, jb.n2
        w_fwd, w_chain = _numpy(jb.w_fwd), _numpy(dplan.w_chain_inv)
        roots = [int(w[n1 // 2, 1]) for w in w_fwd]
        iroots = [int(w[n1 // 2, 1]) for w in w_chain]
        polys = [ReductionPolynomial.X_N_minus if pow(r, n1 * n2, q) == 1
                 else ReductionPolynomial.X_N_plus for r, q in zip(roots, jb.qs)]
        base = RNSFourStepPlan.from_arrays(
            list(jb.qs), jb.logn, n1, n2, polys, roots, iroots,
            [int(v) for v in _numpy(jb.n_inv_rep).reshape(-1)], _numpy(jb.n1_fwd),
            _numpy(jb.n2_fwd), _numpy(jb.n1_inv), _numpy(jb.n2_inv), w_fwd, _numpy(jb.w_inv),
            device=device, dtype=np.uint64 if jb.is64 else np.uint32)
        plan = DistRNSFourStepPlan._of(base)
        word = 64 if jb.is64 else 32
        plan._lazy["w_chain"] = [
            tuple(from_numpy_u64(t, base.device)
                  for t in (w, bo.shoup_companion(w, q, word)))
            for w, q in zip(w_chain, jb.qs)]
        return plan

    def w_local(self, sp: int, rank: int) -> list:
        """Per member, (w, w_shoup, w_chain_inv, w_chain_inv_shoup) of this
        rank's columns, as DistFourStepPlan.w_local builds them."""
        key = ("w", sp, rank)
        if key not in self._lazy:
            width = self.base.n2 // sp
            cols = slice(rank * width, (rank + 1) * width)
            out = []
            for i, m in enumerate(self.base.members):
                if "w" in m._lazy and "w_chain" in self._lazy:
                    full = (*m._lazy["w"][:2], *self._lazy["w_chain"][i])
                    out.append(tuple(t[:, cols].contiguous() for t in full))
                    continue
                word = 64 if m.is64 else 32
                tabs = []
                for root in (m.root, m.iroot):
                    w = _w_columns(m, root, rank * width, width)
                    tabs += [from_numpy_u64(w, m.device),
                             from_numpy_u64(bo.shoup_companion(w, m.q, word), m.device)]
                out.append(tuple(tabs))
            self._lazy[key] = out
        return self._lazy[key]

    def to(self, device) -> "DistRNSFourStepPlan":
        """This plan with its tables on `device` (copies are cached)."""
        base = self.base.to(device)
        if base.device == self.device:
            return self
        if base.device not in self._moved:
            def move(v):
                if isinstance(v, list):
                    return [move(t) for t in v]
                return tuple(t.to(base.device) for t in v)

            self._moved[base.device] = DistRNSFourStepPlan(
                base=base, col=self.col.to(base.device), row=self.row.to(base.device),
                _lazy={k: move(v) for k, v in self._lazy.items()})
        return self._moved[base.device]


def local_schedule(mod_idx, rows: int, mesh, mod_count: int) -> np.ndarray:
    """This rank's rows' schedule from a global one (B = rows * dp
    entries: its dp block), a local one (`rows` entries) or one entry."""
    m = np.asarray(mod_idx, dtype=np.int64).reshape(-1)
    dp, idx = axis(mesh, "dp")
    if len(m) == rows * dp and dp > 1:
        m = m[idx * rows:(idx + 1) * rows]
    return checked_schedule(m, mod_count, rows)


def _transform(v, plan: RNSMergePlan, mod_idx, inverse: bool, use_pallas):
    """The ladder's transform of each row of a (b, m, c) block along its
    last axis, row b under mod_idx[b]."""
    rows = v.reshape(-1, v.shape[-1])
    midx = np.repeat(mod_idx, rows.shape[0] // len(mod_idx))
    if use_pallas:
        y = (intt_rns_lanes if inverse else ntt_rns_lanes)(rows, plan, midx)
    else:
        y = (rns_intt_lanes if inverse else rns_ntt_lanes)(rows, plan, midx)
    return y.view(v.shape)


def _per_row(v, mod_idx, fn) -> torch.Tensor:
    """fn(rows, i) on each member i's rows of a block (row b under mod_idx[b])."""
    return per_modulus(fn, range(int(mod_idx.max()) + 1), mod_idx, v)


def dist_rns_fourstep_ntt(x: torch.Tensor, dplan: DistRNSFourStepPlan, mesh, mod_idx,
                          local_engine: str | None = None) -> torch.Tensor:
    """Forward distributed RNS 4-step of this rank's (B/dp, n1, n2/sp)
    block; returns its (B/dp, n2, n1/sp) block of the spectrum, row b
    bit-identical to the single-chip 4-step under member mod_idx[b].
    `local_engine` as in dist_fourstep_ntt."""
    sp, rank, group = sp_group(mesh)
    dplan = dplan.to(x.device)
    b = dplan.base
    check_block(x, (b.n1, b.n2 // sp), mesh)
    mi = local_schedule(mod_idx, x.shape[0], mesh, b.mod_count)
    use_pallas = _use_pallas(local_engine)
    w = dplan.w_local(sp, rank)

    def cols(u):
        v = _transform(u.transpose(1, 2), dplan.col, mi, False, use_pallas).transpose(1, 2)
        return _per_row(v, mi, lambda r, i: b.members[i].ops().mulc(r, *w[i][:2]))

    def rows(v):
        return _transform(v, dplan.row, mi, False, use_pallas).transpose(1, 2).contiguous()

    return pipelined(x, 1, cols, 1, rows, group, sp)


def dist_rns_fourstep_intt(s: torch.Tensor, dplan: DistRNSFourStepPlan, mesh, mod_idx,
                           local_engine: str | None = None) -> torch.Tensor:
    """Inverse distributed RNS 4-step: the exact inverse of
    dist_rns_fourstep_ntt under the same schedule, each row's n^-1 last."""
    sp, rank, group = sp_group(mesh)
    dplan = dplan.to(s.device)
    b = dplan.base
    check_block(s, (b.n2, b.n1 // sp), mesh)
    mi = local_schedule(mod_idx, s.shape[0], mesh, b.mod_count)
    use_pallas = _use_pallas(local_engine)
    w = dplan.w_local(sp, rank)

    def rows(v):
        return _transform(v.transpose(1, 2), dplan.row, mi, True, use_pallas)

    def cols(u):
        def chain(r, i):
            m = b.members[i]
            return m.ops().mulc(r, *w[i][2:])

        u = _per_row(u, mi, chain)
        u = _transform(u.transpose(1, 2), dplan.col, mi, True, use_pallas).transpose(1, 2)
        return _per_row(u, mi, lambda r, i: b.members[i].ops().mulc(
            r, b.members[i].n_inv, signed(b.members[i].n_inv_shoup))).contiguous()

    return pipelined(s, 1, rows, 2, cols, group, sp)
