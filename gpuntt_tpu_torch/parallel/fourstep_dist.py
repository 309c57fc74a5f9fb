"""Distributed 4-step NTT over a device mesh, on torch.distributed.

The port of the JAX package's parallel/fourstep_dist.py.  The 4-step's
N = n1 x n2 decomposition is the sharding backbone: with the n2 axis of
the (B, n1, n2) block sharded over mesh axis "sp",

  the column (n1-point) NTTs are local,
  the W twiddle product is local (this rank's columns of W),
  one all_to_all_single on the sp group reshards n2-sharded to
    n1-sharded (the distributed transpose),
  the row (n2-point) NTTs are local.

The batch rides mesh axis "dp" with no communication.  Forward maps the
rank's (B/dp, n1, n2/sp) block to its (B/dp, n2, n1/sp) block of the
(B, n2, n1) spectrum (NTT4StepCPU.ntt's layout); the inverse runs the
inverse chain (GS stages, W^-1 with the forward's index pattern, one
n^-1) back.  Exact integer arithmetic makes both bit-identical to the
single-chip 4-step and to the JAX package.

Local work, per shard:

- the column phase: for a u64 plan with q < 2^62, 8 <= n1 <= 512 and
  X^N - 1 (`DistFourStepPlan.colmat`), and a shard width holding whole
  tiles of 128 columns (`_colmat_ok`), one K7' launch
  (hopper_merge_large.col_phase_local) computes W o colNTT(x) forward
  and colINTT(W^-1 o x), unscaled, inverse; otherwise the n1-point
  sub-plan's transform down the columns, then the elementwise W product
  in plain torch, as JAX computes it in XLA;
- the rows: the n2-point sub-plan's transform;
- the sub-plans are X^n - 1 MergePlans of root^(N / n) with n_inv = 1,
  and their transforms are ntt_lanes / intt_lanes, which route them to
  K1/K2 at 2^12-2^17, the big-ring composition above, the u32 kernels,
  or the engine (`local_engine="xla"` asks for the engine everywhere,
  as JAX's "xla"; None, or "mxu", takes the kernels, whose plain
  versions run on a CPU tensor).

The all_to_all needs each rank's chunks contiguous along the split axis:
forward, a (sp, B, n1/sp, n2/sp) copy of the column phase's output before
it and a (B, n1/sp, n2) copy after it; inverse, the same two around
the reverse exchange.  At sp = 1 both are views and the exchange is one
device copy.  `pipeline_chunks` > 1 splits the local batch into chunks,
each with its own asynchronous all_to_all (async_op=True), so one
chunk's exchange overlaps the next chunk's column phase; a batch it does
not divide runs as one chunk, as in JAX.  Bit-exact either way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import barrett as bo
from ..ops import hopper_merge_large as hml
from ..ops.dispatch import intt_lanes, ntt_lanes
from ..ops.fourstep import FourStepPlan
from ..ops.limb import from_numpy_u64, signed
from ..ops.merge_ntt import MergePlan
from ..params.bitrev import bitreverse
from ..params.fourstep import NTTParameters4Step
from ..params.merge import ReductionPolynomial
from .mesh import check_device, sp_group

COLMAT_TILE = 128  # K7''s W tile: any shard width of whole tiles takes it


def _sub_plan(plan: FourStepPlan, nloc: int) -> MergePlan:
    """The nloc-point X^nloc - 1 merge plan of root^(N / nloc), n_inv = 1."""
    q, k = plan.q, plan.n // nloc
    return hml.sub_plan(q, nloc.bit_length() - 1, False, pow(plan.root, k, q),
                        pow(plan.iroot, k, q), 1, plan.device,
                        np.uint64 if plan.is64 else np.uint32)


def _colmat(plan: FourStepPlan) -> hml.LargePlan | None:
    """The column-only big-ring plan of K7' (JAX's `colmat`): the big-ring
    column phase at X^N - 1 with A = n1 IS the 4-step's column NTT then W,
    and n_inv = n2^-1 leaves the inverse column unscaled."""
    q = plan.q
    if not (hml.COLUMNS.admits(plan.is64, q, plan.logn) and 8 <= plan.n1 <= 512
            and plan.poly == ReductionPolynomial.X_N_minus
            and pow(plan.root, plan.n, q) == 1 and plan.root * plan.iroot % q == 1):
        return None
    return hml.LargePlan.from_spec(q, plan.logn, plan.root, plan.iroot, False,
                                   pow(plan.n2, q - 2, q), a_col=plan.n1, tile=COLMAT_TILE,
                                   col_only=True, device=plan.device)


def _w_columns(plan: FourStepPlan, root: int, j0: int, width: int) -> np.ndarray:
    """Columns j0 .. j0 + width - 1 of W[i, j] = root^(br(i) j), (n1, width)."""
    log1 = plan.n1.bit_length() - 1
    return np.stack([hml.pows(pow(root, bitreverse(i, log1), plan.q), plan.q,
                              j0 + width)[j0:] for i in range(plan.n1)])


def _numpy(a) -> np.ndarray:
    """A JAX plan's table as uint64: a (hi, lo) pair of uint32 arrays (u64
    lanes, or a 4-tuple with the Shoup companion's), or one array."""
    if isinstance(a, tuple) or hasattr(a, "hi"):
        hi, lo = (np.asarray(v, dtype=np.uint64) for v in (a[0], a[1]))
        return (hi << np.uint64(32)) | lo
    return np.asarray(a).astype(np.uint64)


@dataclass(frozen=True, eq=False)
class DistFourStepPlan:
    """The single-chip FourStepPlan (`base`), the n1- and n2-point
    sub-plans of the local transforms (n_inv = 1), and K7''s column-only
    big-ring plan (`colmat`, or None).  The W tables are built one rank's
    columns at a time, at first use (`w_local`): at 2^24 the full forward
    and chain-inverse W with their Shoup companions would be 512 MiB,
    and the colmat route reads neither."""

    base: FourStepPlan
    col: MergePlan
    row: MergePlan
    colmat: hml.LargePlan | None = None
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # ("w", sp, rank): this rank's W columns; "w_chain": a carried full W^-1
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.base.device

    @staticmethod
    def from_params(p: NTTParameters4Step, device=None) -> "DistFourStepPlan":
        """The plan of `p`; `device` as in FourStepPlan.from_params (the
        card by default, NTTDeviceError without one)."""
        base = FourStepPlan.from_params(p, device=device)
        return DistFourStepPlan._of(base, _colmat(base))

    @staticmethod
    def _of(base: FourStepPlan, colmat) -> "DistFourStepPlan":
        return DistFourStepPlan(base=base, col=_sub_plan(base, base.n1),
                                row=_sub_plan(base, base.n2), colmat=colmat)

    @staticmethod
    def from_jax(dplan, device=None) -> "DistFourStepPlan":
        """The port's plan of a JAX DistFourStepPlan, from its tables: the
        base plan's small tables and W, the chain-inverse W and colmat's
        W tile and scale tables (converted as FourStepPlan.from_arrays and
        LargePlan.from_jax_arrays convert them).  The root pair is read
        off W (root^1 at row br^-1(1) = n1 / 2, column 1)."""
        jb = dplan.base
        n1, n2 = jb.n1, jb.n2
        w_fwd, w_chain = _numpy(jb.w_fwd), _numpy(dplan.w_chain_inv)
        root, iroot = int(w_fwd[n1 // 2, 1]), int(w_chain[n1 // 2, 1])
        q = jb.q
        poly = (ReductionPolynomial.X_N_minus if pow(root, jb.n1 * n2, q) == 1
                else ReductionPolynomial.X_N_plus)
        base = FourStepPlan.from_arrays(
            q, jb.logn, n1, n2, poly, root, iroot, int(_numpy(jb.n_inv_rep)),
            _numpy(jb.n1_fwd), _numpy(jb.n2_fwd), _numpy(jb.n1_inv), _numpy(jb.n2_inv),
            w_fwd, _numpy(jb.w_inv), device=device,
            dtype=np.uint64 if jb.is64 else np.uint32)
        colmat = None
        if dplan.colmat is not None:
            m = dplan.colmat
            colmat = hml.LargePlan.from_jax_arrays(
                m.q, m.logn, m.A, m.B, m.tile, _numpy(m.wt_fwd), _numpy(m.ws_fwd),
                _numpy(m.wt_inv), _numpy(m.ws_inv), n_inv=pow(n2, q - 2, q), col_only=True,
                device=base.device)
        plan = DistFourStepPlan._of(base, colmat)
        word = 64 if jb.is64 else 32
        plan._lazy["w_chain"] = tuple(from_numpy_u64(t, base.device) for t in (
            w_chain, bo.shoup_companion(w_chain, q, word)))
        return plan

    def w_local(self, sp: int, rank: int) -> tuple[torch.Tensor, ...]:
        """(w, w_shoup, w_chain_inv, w_chain_inv_shoup): columns
        [rank n2 / sp, (rank + 1) n2 / sp) of the forward W and of its
        elementwise inverse, each (n1, n2 / sp), built at first call and
        cached (carried tables are sliced)."""
        key = ("w", sp, rank)
        if key not in self._lazy:
            b = self.base
            width = b.n2 // sp
            cols = slice(rank * width, (rank + 1) * width)
            if "w" in b._lazy and "w_chain" in self._lazy:
                full = (*b._lazy["w"][:2], *self._lazy["w_chain"])
                self._lazy[key] = tuple(t[:, cols].contiguous() for t in full)
            else:
                word = 64 if b.is64 else 32
                out = []
                for root in (b.root, b.iroot):
                    w = _w_columns(b, root, rank * width, width)
                    out += [from_numpy_u64(w, b.device),
                            from_numpy_u64(bo.shoup_companion(w, b.q, word), b.device)]
                self._lazy[key] = tuple(out)
        return self._lazy[key]

    def to(self, device) -> "DistFourStepPlan":
        """This plan with its tables on `device` (copies are cached)."""
        base = self.base.to(device)
        if base.device == self.device:
            return self
        if base.device not in self._moved:
            self._moved[base.device] = DistFourStepPlan(
                base=base, col=self.col.to(base.device), row=self.row.to(base.device),
                colmat=None if self.colmat is None else self.colmat.to(base.device),
                _lazy={k: tuple(t.to(base.device) for t in v) for k, v in self._lazy.items()})
        return self._moved[base.device]


def _use_pallas(local_engine) -> bool | str:
    """ntt_lanes' `use_pallas` for a `local_engine`: None / "mxu" the
    kernels (their plain versions on a CPU tensor), "xla" the engine."""
    if local_engine in (None, "mxu"):
        return "auto"
    if local_engine == "xla":
        return False
    raise ValueError(f"local_engine must be None, 'mxu' or 'xla', got {local_engine!r}")


def _colmat_ok(dplan: DistFourStepPlan, sp: int, local_engine) -> bool:
    """K7' needs each shard's n2 slice to hold a whole number of tiles."""
    if local_engine == "xla" or dplan.colmat is None:
        return False
    width = dplan.base.n2 // sp
    return width >= dplan.colmat.tile and width % dplan.colmat.tile == 0


def _along_columns(v: torch.Tensor, plan: MergePlan, inverse: bool, use_pallas):
    """The plan's transform down axis 1 of a (b, n, c) block."""
    b, n, c = v.shape
    rows = v.transpose(1, 2).reshape(b * c, n)
    y = (intt_lanes if inverse else ntt_lanes)(rows, plan, use_pallas=use_pallas)
    return y.view(b, c, n).transpose(1, 2).contiguous()


def _along_rows(v: torch.Tensor, plan: MergePlan, inverse: bool, use_pallas):
    """The plan's transform along the last axis of a block."""
    y = (intt_lanes if inverse else ntt_lanes)(v.reshape(-1, v.shape[-1]), plan,
                                               use_pallas=use_pallas)
    return y.view(v.shape)


def exchange(v: torch.Tensor, group, sp: int, split: int, async_op: bool):
    """Start the distributed transpose of a (b, m, c) block: split axis
    `split` (1 or 2) into sp chunks, chunk k to rank k of `group`, and
    return (finish, work): `finish()` gathers what arrived along the other
    axis once `work` (None when synchronous) is waited for."""
    b, m, c = v.shape
    if split == 1:
        chunks = v.view(b, sp, m // sp, c).transpose(0, 1)
    else:
        chunks = v.view(b, m, sp, c // sp).permute(2, 0, 1, 3)
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)

    def finish():
        if split == 1:  # (sp, b, m/sp, c) from each rank's columns -> (b, m/sp, sp c)
            return recv.permute(1, 2, 0, 3).reshape(b, m // sp, sp * c)
        return recv.transpose(0, 1).reshape(b, sp * m, c // sp)

    return finish, work


def pipelined(x: torch.Tensor, chunks: int, first, split: int, second, group, sp: int):
    """second(exchange(first(u))) over `chunks` batch chunks of x, every
    chunk's exchange started (asynchronously when there are several)
    before any chunk's second phase; one chunk when chunks does not
    divide the batch."""
    b = x.shape[0]
    parts = list(x.split(b // chunks)) if chunks > 1 and b % chunks == 0 else [x]
    started = [exchange(first(u), group, sp, split, len(parts) > 1) for u in parts]
    outs = []
    for finish, work in started:
        if work is not None:
            work.wait()
        outs.append(second(finish()))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def check_block(x: torch.Tensor, shape: tuple, mesh) -> None:
    """A transform's operand: a (batch, *shape) int64 block on the mesh's device."""
    check_device(x, mesh)
    if x.dim() != 3 or tuple(x.shape[1:]) != shape or x.dtype != torch.int64:
        raise ValueError(f"expected a (batch, {shape[0]}, {shape[1]}) int64 block, "
                         f"got {tuple(x.shape)} {x.dtype}")


def dist_fourstep_ntt(x: torch.Tensor, dplan: DistFourStepPlan, mesh,
                      local_engine: str | None = None,
                      pipeline_chunks: int = 1) -> torch.Tensor:
    """Forward distributed 4-step NTT of this rank's (B/dp, n1, n2/sp)
    block (`mesh.shard(x, mesh, BLOCKS)` of the (B, n1, n2) input);
    returns its (B/dp, n2, n1/sp) block of the (B, n2, n1) spectrum.
    `local_engine` and `pipeline_chunks` as in the module note."""
    sp, rank, group = sp_group(mesh)
    dplan = dplan.to(x.device)
    b = dplan.base
    check_block(x, (b.n1, b.n2 // sp), mesh)
    use_pallas = _use_pallas(local_engine)
    ops = b.ops()

    def cols(u):
        if _colmat_ok(dplan, sp, local_engine):
            return hml.col_phase_local(u.contiguous(), dplan.colmat, rank, sp, False)
        w, ws = dplan.w_local(sp, rank)[:2]
        return ops.mulc(_along_columns(u, dplan.col, False, use_pallas), w, ws)

    def rows(v):  # (b, n1/sp, n2) -> (b, n2, n1/sp)
        return _along_rows(v, dplan.row, False, use_pallas).transpose(1, 2).contiguous()

    return pipelined(x, pipeline_chunks, cols, 1, rows, group, sp)


def dist_fourstep_intt(s: torch.Tensor, dplan: DistFourStepPlan, mesh,
                       local_engine: str | None = None,
                       pipeline_chunks: int = 1) -> torch.Tensor:
    """Inverse distributed 4-step NTT: this rank's (B/dp, n2, n1/sp) block
    of the spectrum to its (B/dp, n1, n2/sp) block; the exact inverse of
    dist_fourstep_ntt, with the one n^-1 last."""
    sp, rank, group = sp_group(mesh)
    dplan = dplan.to(s.device)
    b = dplan.base
    check_block(s, (b.n2, b.n1 // sp), mesh)
    use_pallas = _use_pallas(local_engine)
    ops = b.ops()

    def rows(v):  # (b, n2, n1/sp) -> (b, n1/sp, n2), unscaled
        return _along_rows(v.transpose(1, 2), dplan.row, True, use_pallas)

    def cols(u):  # (b, n1, n2/sp)
        if _colmat_ok(dplan, sp, local_engine):
            u = hml.col_phase_local(u.contiguous(), dplan.colmat, rank, sp, True)
        else:
            wci, wcis = dplan.w_local(sp, rank)[2:]
            u = _along_columns(ops.mulc(u, wci, wcis), dplan.col, True, use_pallas)
        return ops.mulc(u, b.n_inv, signed(b.n_inv_shoup))

    return pipelined(s, pipeline_chunks, rows, 2, cols, group, sp)
