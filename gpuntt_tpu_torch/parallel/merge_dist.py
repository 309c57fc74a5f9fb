"""Distributed merge NTT — the butterfly exchange, on torch.distributed.

The port of the JAX package's parallel/merge_dist.py, the second
distribution strategy: the coefficient axis of a (B, N) batch is cut
into sp contiguous blocks over mesh axis "sp".  The first log2(sp)
Cooley-Tukey stages pair elements of different ranks: each such stage
swaps whole shards between butterfly partners (rank ^ dist, a group rank,
mapped to its global rank for batch_isend_irecv), and since all elements
of a shard share one butterfly group there, the twiddle is one scalar per
shard (`_cross_w`), a power of the root computed directly: no table, let
alone the N-entry one, is built for these stages.  Every later stage is
shard-local.

The local tail: shard r runs the rest of the network on the subtree of
the bit-reversed table rooted at index sp + r, which is the
evaluation-twisted transform out[k'] = sum_j x_j (Psi_r Omega^br(k'))^j
of N / sp points, Omega = root^sp (X^N - 1: Psi_r = root^br(r);
X^N + 1: Omega = psi^(2 sp), Psi_r = psi^(2 br(r) + 1)).  Its plan is
MergePlan.from_eval (`merge_dist_tails`, cached per rank): local stage s'
reads table[lo + r m' + g'] of the full network, which from_eval lays out
as entry m' + g' of its own heap-ordered table (X^N - 1's tables index
from 0, X^N + 1's from m; the kernels' `xnp` flag changes only that
offset, so the heap order serves both).  So the tail runs on the
kernels through ntt_lanes / intt_lanes: K1/K2 for tails of 2^12-2^17,
the big-ring composition (K7 + K1 or K8, from LargePlan.from_eval, whose
column plan and W factors carry the twist) from 2^18, the u32 kernels,
or the engine.  At X^N - 1, rank 0's tail is the plain Omega transform.
A plan whose factors are not a root of unity keeps its tables: the tail
is a slice of them, on the engine, as JAX keeps the XLA stages.

The tails have n^-1 = 1; the global n^-1 follows the inverse cross
stages.  Outputs are bit-identical to the single-chip ntt_lanes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.dispatch import intt_lanes, ntt_lanes
from ..ops.limb import signed, to_numpy_u64
from ..ops.merge_ntt import MergePlan
from ..params.bitrev import bitreverse
from ..params.merge import ReductionPolynomial
from .fourstep_dist import _use_pallas
from .mesh import check_device, sp_group


def _shard_twists(plan: MergePlan, sp: int, rank: int):
    """(Omega, Omega^-1, Psi_r, Psi_r^-1) of rank `rank`'s tail."""
    q, r, ri = plan.q, plan.root, plan.iroot
    br = bitreverse(rank, sp.bit_length() - 1)
    if plan.xnp:
        return pow(r, 2 * sp, q), pow(ri, 2 * sp, q), pow(r, 2 * br + 1, q), pow(ri, 2 * br + 1, q)
    return pow(r, sp, q), pow(ri, sp, q), pow(r, br, q), pow(ri, br, q)


def _sliced_tail(plan: MergePlan, sp: int, rank: int) -> MergePlan:
    """The tail of a plan with caller tables: entry m' + g' of its heap
    order is entry lo + rank m' + g' of the plan's tables (engine only:
    its root pair (0, 0) is no root, so dispatch never routes it)."""
    tabled = plan.with_tables()
    nl = plan.n // sp
    tables = []
    for t in (tabled.fwd_table, tabled.inv_table):
        t = to_numpy_u64(t) if plan.is64 else t.cpu().numpy().astype(np.uint64)
        heap = np.ones(nl, dtype=np.uint64)
        m = 1
        while m < nl:
            lo = m * sp if plan.xnp else 0
            heap[m:2 * m] = t[lo + rank * m:lo + rank * m + m]
            m *= 2
        tables.append(heap)
    return MergePlan.from_arrays(plan.q, plan.logn - (sp.bit_length() - 1),
                                 ReductionPolynomial.X_N_plus, 0, 0, 1, *tables,
                                 device=plan.device,
                                 dtype=np.uint64 if plan.is64 else np.uint32)


def merge_dist_tails(plan: MergePlan, sp: int, rank: int) -> MergePlan:
    """Rank `rank`'s local-tail plan of a transform sharded over sp ranks
    (the port's merge_dist_mxu): MergePlan.from_eval with n_inv = 1, or a
    slice of caller tables; cached on `plan`."""
    key = ("dist", sp, rank)
    if key not in plan._lazy:
        lognl = plan.logn - (sp.bit_length() - 1)
        if plan.genuine_root:
            plan._lazy[key] = MergePlan.from_eval(
                plan.q, lognl, *_shard_twists(plan, sp, rank), 1, device=plan.device,
                dtype=np.uint64 if plan.is64 else np.uint32)
        else:
            plan._lazy[key] = _sliced_tail(plan, sp, rank)
    return plan._lazy[key]


def _cross_w(plan: MergePlan, s: int, logsp: int, rank: int, inverse: bool):
    """The scalar twiddle of cross stage s on rank `rank` and its Shoup
    companion: entry lo + g of the bit-reversed table (g = rank >>
    (logsp - s); lo = 2^s for X^N + 1, else 0), from the root pair."""
    idx = ((1 << s) if plan.xnp else 0) + (rank >> (logsp - s))
    if plan.genuine_root:
        log_size = plan.logn if plan.xnp else plan.logn - 1
        w = pow(plan.iroot if inverse else plan.root, bitreverse(idx, log_size), plan.q)
    else:
        tabled = plan.with_tables()
        w = int((tabled.inv_table if inverse else tabled.fwd_table)[idx].item()) % (1 << 64)
    word = 64 if plan.is64 else 32
    return w, signed((w << word) // plan.q)


def _partner(x: torch.Tensor, group, peer: int) -> torch.Tensor:
    """Swap x with group rank `peer`; return what it sent."""
    other = torch.empty_like(x)
    g = dist.get_global_rank(group, peer)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, g, group),
                                       dist.P2POp(dist.irecv, other, g, group)]):
        req.wait()
    return other


def _check_rows(x: torch.Tensor, plan: MergePlan, sp: int, mesh) -> torch.Tensor:
    check_device(x, mesh)
    if x.dim() != 2 or x.shape[1] * sp != plan.n or x.dtype != torch.int64:
        raise ValueError(f"expected (batch, {plan.n // sp}) int64 rows, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.contiguous()


def dist_merge_ntt(x: torch.Tensor, plan: MergePlan, mesh,
                   local_engine: str | None = None) -> torch.Tensor:
    """Forward merge NTT of this rank's (B/dp, N/sp) block of a (B, N)
    batch (`mesh.shard(x, mesh, ROWS)`): its block of ntt_lanes' output.
    `local_engine` as in dist_fourstep_ntt; the tail plan is
    merge_dist_tails(plan, sp, rank), cached on `plan`."""
    sp, rank, group = sp_group(mesh)
    plan = plan.to(x.device)
    x = _check_rows(x, plan, sp, mesh)
    logsp, ops = sp.bit_length() - 1, plan.ops()
    for s in range(logsp):
        dist_ = sp >> (s + 1)
        other = _partner(x, group, rank ^ dist_)
        w, ws = _cross_w(plan, s, logsp, rank, False)
        if (rank // dist_) % 2 == 0:  # this shard holds u
            x = ops.add(x, ops.mulc(other, w, ws))
        else:
            x = ops.sub(other, ops.mulc(x, w, ws))
    return ntt_lanes(x, merge_dist_tails(plan, sp, rank), use_pallas=_use_pallas(local_engine))


def dist_merge_intt(x: torch.Tensor, plan: MergePlan, mesh, scale: bool = True,
                    local_engine: str | None = None) -> torch.Tensor:
    """Inverse merge NTT (GS) of this rank's block; the global n^-1 last
    (or none with scale=False).  Arguments as in dist_merge_ntt."""
    sp, rank, group = sp_group(mesh)
    plan = plan.to(x.device)
    x = _check_rows(x, plan, sp, mesh)
    logsp, ops = sp.bit_length() - 1, plan.ops()
    x = intt_lanes(x, merge_dist_tails(plan, sp, rank),
                   use_pallas=_use_pallas(local_engine)).contiguous()
    for s in range(logsp - 1, -1, -1):
        dist_ = sp >> (s + 1)
        other = _partner(x, group, rank ^ dist_)
        if (rank // dist_) % 2 == 0:
            x = ops.add(x, other)
        else:
            x = ops.mulc(ops.sub(other, x), *_cross_w(plan, s, logsp, rank, True))
    if scale:
        x = ops.mulc(x, plan.n_inv, signed(plan.n_inv_shoup))
    return x
