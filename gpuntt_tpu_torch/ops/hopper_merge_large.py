"""Hopper kernels of the u64 big-ring merge NTT (logn 18-28), their plain
versions, the plan and the composition.

The counterpart of the JAX package's ops/pallas_mxu_large.py.  A ring of
N = A * B words is an (A, B) matrix, and the merged NTT is three steps
(pallas_mxu_large.py:155-345):

1. an A-point merge NTT down every column, whose bases are psi^B for
   X^N + 1 and omega^B for X^N - 1 (`LargePlan.col`, a MergePlan of A
   entries);
2. a twist by W[a, b] = w_a^b, factored as an (A, T) tile table times a
   per-tile scale (B / T, A), so no N-entry table exists;
3. a B-point X^B - 1 merge NTT along every row, with root psi^(2A) for
   X^N + 1 and omega^A for X^N - 1.

The inverse runs the rows first (B^-1 folded in), then W^-1, then the
column inverse with A^-1 folded in.  Two CUDA kernels, in
csrc/merge_u64_large.cu, replace the two Pallas kernels of that module:

    merge_u64_large_colfwd  <- _colfwd_kernel     (K7 forward, :388)
    merge_u64_large_colinv  <- _colinv_kernel     (K7 inverse, :398)
    merge_u64_large_rowmat  <- _row_matmul_kernel (K8, :499), rows of B <= 512

and the rows of B = 2^11..2^17 run on hopper_merge.py's K1/K2/K3 through
B-point sub-plans, as the JAX route runs them on its in-VMEM kernels.
Rows of more than 2^17 words recurse into a nested LargePlan (logn
27-28).  Splits, by the JAX package's rule:

    logn    A    B     rows
    18     128  2^11   K1/K2/K3 at logn 11 (from_params; from_spec's 512 x 512 uses K8)
    19-23  128  2^11..2^15  K1/K2/K3
    24     256  2^16   K1/K2/K3
    25     512  2^16   K1/K2/K3
    26     512  2^17   K1/K2 (the product is not fused, as in the JAX route)
    27     512  2^18   nested logn 18, A = B = 512: K7 and K8
    28     512  2^19   nested logn 19, 128 x 2^12: K7 and K1/K2

The JAX package's ceiling at 2^16 rows (a v5e VMEM limit, with the
inverse at 2^17 delegated per direction) has no counterpart here:
K1/K2 take 2^17 rows in both directions, which `max_row_logn` = 17
says.

Each wrapper takes contiguous int64 tensors of u64 bit patterns and a
plan on the same device.  On a CPU tensor it runs the kernel's plain
version, and only there; on a CUDA tensor it launches the kernel or
raises.  Every launch adds one to its kernel's `launches`, every
plain-version call through a wrapper one to `plain_calls`;
`reset_counts()` zeroes both.  `merge_u64_large_plain` composes the
plain versions alone, on any device, which is how the kernels are
checked on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from ..params.bitrev import bitrev_permute, bitreverse
from ..params.merge import NTTParameters, ReductionPolynomial, _power_table
from . import barrett as bo
from . import hopper_merge as hm
from .hopper_merge import KernelStats, _launch
from .limb import from_numpy_u64
from .merge_ntt import MergePlan, merge_intt_lanes, merge_ntt_lanes

SOURCE = "gpuntt_tpu_torch/csrc/merge_u64_large.cu"

A_COL = 128          # the JAX package's default column count
ROW_MAT_MAX = 512    # K8 takes rows of B <= 512 words
MAX_ROW_LOGN = 17    # K1-K3 take rows of 2^11..2^17 words

COLFWD = KernelStats("merge_u64_large_colfwd", "gpuntt_tpu/ops/pallas_mxu_large.py:388",
                     source=SOURCE)
COLINV = KernelStats("merge_u64_large_colinv", "gpuntt_tpu/ops/pallas_mxu_large.py:398",
                     source=SOURCE)
ROWMAT = KernelStats("merge_u64_large_rowmat", "gpuntt_tpu/ops/pallas_mxu_large.py:499",
                     source=SOURCE)
KERNELS = (COLFWD, COLINV, ROWMAT)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here: u64, q < 2^62, logn
    18-28 (with a genuine root, which dispatch checks)."""
    return plan.is64 and plan.q < (1 << 62) and 18 <= plan.logn <= 28


# ------------------------------------------------------------------- plan


def _pows(base: int, q: int, size: int) -> np.ndarray:
    """[base^0, ..., base^(size-1)] mod q as uint64."""
    from .. import _native

    if _native.available():
        return _native.power_table(base % q, q, size)
    return np.asarray(_power_table(base, q, size), dtype=np.uint64)


def _merge_plan(q: int, logn: int, xnp: bool, root: int, iroot: int, n_inv: int,
                device, dtype=np.uint64) -> MergePlan:
    """A 2^logn-point merge plan from its root pair (sub-plans)."""
    size = 1 << logn if xnp else 1 << (logn - 1)
    poly = ReductionPolynomial.X_N_plus if xnp else ReductionPolynomial.X_N_minus
    return MergePlan.from_arrays(q, logn, poly, root, iroot, n_inv,
                                 bitrev_permute(_pows(root, q, size)),
                                 bitrev_permute(_pows(iroot, q, size)), device=device,
                                 dtype=dtype)


def _w_factor(bases, tile: int, B: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """W[a, jT + t] = bases[a]^(jT + t) as the (A, T) tile table
    bases[a]^t and the (B / T, A) scale table bases[a]^(jT)
    (pallas_mxu.py:179-187, without its trailing unit axis)."""
    wt = np.stack([_pows(b, q, tile) for b in bases])
    ws = np.stack([_pows(pow(b, tile, q), q, B // tile) for b in bases], axis=1)
    return wt, ws


def _refactor(wt: np.ndarray, ws: np.ndarray, tile: int, q: int):
    """The factored W of tables (wt, ws) at another tile width: each new
    entry is W[a, b] = wt[a, b % T] * ws[b // T, a] mod q."""
    A, T = wt.shape
    B = ws.shape[0] * T

    def w(a, b):
        return (wt[a, b % T].astype(object) * ws[b // T, a].astype(object)) % q

    a = np.arange(A)
    wt2 = w(a[:, None], np.arange(tile)[None, :])
    ws2 = w(a[None, :], (np.arange(B // tile) * tile)[:, None])
    return wt2.astype(np.uint64), ws2.astype(np.uint64)


@dataclass(frozen=True, eq=False)
class LargePlan:
    """Column sub-plan, factored W tables with their Shoup companions, and
    the rows: a B-point X^B - 1 MergePlan (`rows`; K8 when B <= 512, else
    K1-K3) or a nested LargePlan (`nested`)."""

    logn: int
    q: int
    A: int
    B: int
    tile: int
    col: MergePlan  # A-point; its n_inv is n_inv * B (A^-1 for the standard scaling)
    wt_fwd: torch.Tensor  # (A, T)
    wt_fwd_shoup: torch.Tensor
    ws_fwd: torch.Tensor  # (B / T, A)
    ws_fwd_shoup: torch.Tensor
    wt_inv: torch.Tensor
    wt_inv_shoup: torch.Tensor
    ws_inv: torch.Tensor
    ws_inv_shoup: torch.Tensor
    rows: MergePlan | None
    nested: Any = None  # LargePlan | None

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def device(self) -> torch.device:
        return self.col.device

    @property
    def row_kernel(self) -> str:
        """What runs the rows: "K8", "K1" (with K2/K3) or "nested"."""
        if self.nested is not None:
            return "nested"
        return "K8" if self.B <= ROW_MAT_MAX else "K1"

    @property
    def fuses_product(self) -> bool:
        """The polymul's product fuses into the row inverse (K3) where the
        JAX route fuses it: rows of 2^11..2^16 (logn 18-25).  Its 2^17
        rows (logn 26) are delegated per direction and carry no fused
        kernel, and the port keeps that split."""
        return self.row_kernel == "K1" and self.B <= 1 << 16

    @staticmethod
    def from_params(p: NTTParameters, a_col: int | None = None, tile: int | None = None,
                    device=None) -> "LargePlan":
        """As MXULargePlan.from_params: the route's split (A = 128 at logn
        18, as `large_plan` builds it) unless `a_col` is given."""
        q = p.modulus.value
        return LargePlan.from_spec(q, p.logn, p.root_of_unity, p.inverse_root_of_unity,
                                   p.poly_reduction == ReductionPolynomial.X_N_plus,
                                   pow(p.n, q - 2, q), a_col=a_col or _route_a_col(p.logn),
                                   tile=tile, device=device)

    @staticmethod
    def _split(logn: int, a_col: int | None, tile: int | None) -> tuple[int, int, int]:
        """(A, B, T) by the JAX rule (pallas_mxu_large.py:193-222)."""
        n = 1 << logn
        if a_col:
            A = a_col
        elif logn == 18 or logn >= 25:
            A = 512
        else:
            A = max(A_COL, n >> 16)
        if A & (A - 1) or not 2 <= A <= 512 or A >= n:
            raise ValueError(f"column count {A} does not split 2^{logn} (2..512, B >= 2)")
        B = n // A
        T = min(B, max(128, (1 << 17) // A)) if tile is None else min(tile, B)
        if T & (T - 1) or T < 2:
            raise ValueError(f"tile {T} is not a power of two >= 2")
        return A, B, T

    @staticmethod
    def from_spec(q: int, logn: int, root: int, iroot: int, xnp: bool, n_inv: int,
                  a_col: int | None = None, tile: int | None = None,
                  max_row_logn: int = MAX_ROW_LOGN, row_kwargs: dict | None = None,
                  device=None) -> "LargePlan":
        """Plan for a merge NTT given its field spec, from exponent algebra
        as MXULargePlan.from_spec builds it (`root` is omega for X^N - 1,
        psi for X^N + 1; `n_inv` the whole inverse scaling).  `a_col`,
        `tile` and `max_row_logn` set the split; `row_kwargs` configure
        a nested plan only."""
        if q >= 1 << 62:
            raise ValueError("the big-ring kernels require q < 2^62")
        order = 2 << logn if xnp else 1 << logn
        if pow(root, order, q) != 1 or root * iroot % q != 1:
            raise ValueError("the big-ring kernels require a genuine root of unity")
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        A, B, T = LargePlan._split(logn, a_col, tile)
        logA, logB = A.bit_length() - 1, B.bit_length() - 1
        brA = [bitreverse(a, logA) for a in range(A)]
        if xnp:
            w_base = [pow(root, 2 * a + 1, q) for a in brA]
            wi_base = [pow(iroot, 2 * a + 1, q) for a in brA]
            row_root, row_iroot = pow(root, 2 * A, q), pow(iroot, 2 * A, q)
        else:
            w_base = [pow(root, a, q) for a in brA]
            wi_base = [pow(iroot, a, q) for a in brA]
            row_root, row_iroot = pow(root, A, q), pow(iroot, A, q)
        b_inv = pow(B, q - 2, q)
        nested = None
        if B > ROW_MAT_MAX and not 11 <= logB <= min(max_row_logn, MAX_ROW_LOGN):
            nested = LargePlan.from_spec(q, logB, row_root, row_iroot, False, b_inv,
                                         max_row_logn=max_row_logn, device=device,
                                         **(row_kwargs or {}))
        return LargePlan._build(q, logn, A, B, T, root, iroot, xnp, n_inv,
                                _w_factor(w_base, T, B, q), _w_factor(wi_base, T, B, q),
                                nested, device)

    @staticmethod
    def _build(q, logn, A, B, T, root, iroot, xnp, n_inv, w_fwd, w_inv, nested,
               device) -> "LargePlan":
        logA, logB = A.bit_length() - 1, B.bit_length() - 1
        col = _merge_plan(q, logA, xnp, pow(root, B, q), pow(iroot, B, q), n_inv * B % q,
                          device)
        rows = None
        if nested is None:
            r_exp = 2 * A if xnp else A
            rows = _merge_plan(q, logB, False, pow(root, r_exp, q), pow(iroot, r_exp, q),
                               pow(B, q - 2, q), device)

        def dev(table):
            table = np.ascontiguousarray(table, dtype=np.uint64)
            return (from_numpy_u64(table, device),
                    from_numpy_u64(bo.shoup_companion(table, q, 64), device))

        (wtf, wtfs), (wsf, wsfs) = dev(w_fwd[0]), dev(w_fwd[1])
        (wti, wtis), (wsi, wsis) = dev(w_inv[0]), dev(w_inv[1])
        return LargePlan(logn=logn, q=q, A=A, B=B, tile=T, col=col,
                         wt_fwd=wtf, wt_fwd_shoup=wtfs, ws_fwd=wsf, ws_fwd_shoup=wsfs,
                         wt_inv=wti, wt_inv_shoup=wtis, ws_inv=wsi, ws_inv_shoup=wsis,
                         rows=rows, nested=nested)

    @staticmethod
    def from_jax_arrays(q: int, logn: int, A: int, B: int, tile: int, wt_fwd, ws_fwd,
                        wt_inv, ws_inv, nested: "LargePlan | None" = None,
                        n_inv: int | None = None, device=None) -> "LargePlan":
        """The plan of a JAX MXULargePlan (from_spec's, psi = 1), from its
        numbers and its W tables as uint64 numpy arrays (hi << 32 | lo of
        the `wt_*`/`ws_*` pairs; `ws_*` as (B / T, A) or (B / T, A, 1)).
        `nested` is the port plan of its nested `row_plan`, converted the
        same way, where it has one.  The root pair and the reduction
        polynomial are read off the tile tables (w_a^1 at the a whose
        bit reversal is 1, or 0 for X^N + 1, whose bases are odd powers);
        the column and row sub-plans follow from them.  An inverse table
        at the JAX package's narrower `tile_inv` is refactored at `tile`.
        `n_inv` defaults to the standard N^-1."""
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        tabs = []
        for wt, ws in ((wt_fwd, ws_fwd), (wt_inv, ws_inv)):
            wt = np.asarray(wt, dtype=np.uint64)
            ws = np.asarray(ws, dtype=np.uint64).reshape(-1, A)
            if wt.shape[0] != A or ws.shape[0] * wt.shape[1] != B:
                raise ValueError(f"W tables {wt.shape}/{ws.shape} do not fit A={A} B={B}")
            tabs.append((wt, ws) if wt.shape[1] == tile else _refactor(wt, ws, tile, q))
        (wtf, _), (wti, _) = tabs
        xnp = int(wtf[0, 1]) != 1
        root = int(wtf[0 if xnp else A // 2, 1])
        iroot = int(wti[0 if xnp else A // 2, 1])
        needs_nested = B > ROW_MAT_MAX and not 1 << 11 <= B <= 1 << MAX_ROW_LOGN
        if (needs_nested and nested is None) or (nested is not None and (
                nested.n != B or B <= ROW_MAT_MAX)):
            raise ValueError(f"rows of {B} words do not fit the nested plan {nested}")
        if n_inv is None:
            n_inv = pow(1 << logn, q - 2, q)
        return LargePlan._build(q, logn, A, B, tile, root, iroot, xnp, n_inv, tabs[0],
                                tabs[1], nested, device)

    def to(self, device) -> "LargePlan":
        """This plan with every table on `device`."""
        return plan_to(self, device)

    def device_bytes(self) -> int:
        """Bytes of every table this plan holds, sub-plans included."""
        return plan_bytes(self)


def plan_to(plan, device):
    """A kernel plan (a frozen dataclass with a `device`) with every
    tensor and sub-plan it holds on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device == plan.device:
        return plan
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).to(device) for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), (torch.Tensor, MergePlan, LargePlan))})


def plan_bytes(plan) -> int:
    """Bytes of every table a kernel plan holds, sub-plans included."""
    total = 0
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif isinstance(v, MergePlan):
            total += sum(t.numel() * t.element_size() for t in
                         (v.fwd_table, v.fwd_shoup, v.inv_table, v.inv_shoup))
        elif isinstance(v, LargePlan):
            total += plan_bytes(v)
    return total


def _route_a_col(logn: int) -> int | None:
    """The route's column count where it differs from from_spec's rule:
    A = 128 at logn 18, rows of 2^11 on K1-K3, as the JAX route's
    MXULargePlan.from_params (from_spec's 512 x 512 split there serves
    the nested rows of logn 27)."""
    return A_COL if logn == 18 else None


def large_plan(plan: MergePlan) -> LargePlan:
    """The big-ring plan of a MergePlan, built on its device at first use
    and cached on it."""
    if "large" not in plan._lazy:
        plan._lazy["large"] = LargePlan.from_spec(
            plan.q, plan.logn, plan.root, plan.iroot, plan.xnp, plan.n_inv,
            a_col=_route_a_col(plan.logn), device=plan.device)
    return plan._lazy["large"]


# ------------------------------------------------------------ plain versions


def _twist(y, wt, wts, ws, wss, lp: LargePlan):
    """y (batch, A, B) times W[a, b] = wt[a, b % T] * ws[b // T, a]."""
    v = y.reshape(y.shape[0], lp.A, lp.B // lp.tile, lp.tile)
    v = bo.shoup_mul64(v, wt[:, None, :], wts[:, None, :], lp.q)
    v = bo.shoup_mul64(v, ws.t()[:, :, None], wss.t()[:, :, None], lp.q)
    return v.reshape(y.shape)


def colfwd_plain(x, lp: LargePlan):
    """K7 forward: x mod q, the A-point NTT down every column, then W."""
    batch = x.shape[0]
    cols = bo.reduce_forced64(x, lp.q).view(batch, lp.A, lp.B).transpose(1, 2)
    y = merge_ntt_lanes(cols, lp.col).transpose(1, 2)
    return _twist(y, lp.wt_fwd, lp.wt_fwd_shoup, lp.ws_fwd, lp.ws_fwd_shoup,
                  lp).reshape(batch, lp.n)


def colinv_plain(x, lp: LargePlan):
    """K7 inverse: x mod q, W^-1, then the column inverse with its c_inv."""
    batch = x.shape[0]
    y = _twist(bo.reduce_forced64(x, lp.q).view(batch, lp.A, lp.B), lp.wt_inv,
               lp.wt_inv_shoup, lp.ws_inv, lp.ws_inv_shoup, lp)
    return merge_intt_lanes(y.transpose(1, 2), lp.col).transpose(1, 2).reshape(batch, lp.n)


def rowmat_plain(x, plan: MergePlan, inverse: bool):
    """K8: x mod q, then the B-point merge NTT (or its inverse, B^-1
    folded) of every row."""
    x = bo.reduce_forced64(x, plan.q)
    return merge_intt_lanes(x, plan) if inverse else merge_ntt_lanes(x, plan)


# ------------------------------------------------------------------ wrappers


def _check(x: torch.Tensor, n: int, device: torch.device) -> None:
    if (x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != n
            or not x.is_contiguous() or x.device != device):
        raise NTTDispatchError(
            f"expected a contiguous (batch, {n}) int64 tensor on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    if x.device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no merge_u64_large kernel for {x.device}")


def _lib():
    from ._build import library

    return library("merge_u64_large")


def _col(stats: KernelStats, entry: str, x, lp: LargePlan, inverse: bool):
    _check(x, lp.n, lp.device)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return (colinv_plain if inverse else colfwd_plain)(x, lp)
    col = lp.col
    if inverse:
        tables = (col.inv_table, col.inv_shoup, lp.wt_inv, lp.wt_inv_shoup, lp.ws_inv,
                  lp.ws_inv_shoup)
        scale = (col.n_inv, col.n_inv_shoup)
    else:
        tables = (col.fwd_table, col.fwd_shoup, lp.wt_fwd, lp.wt_fwd_shoup, lp.ws_fwd,
                  lp.ws_fwd_shoup)
        scale = ()
    y = torch.empty_like(x)
    _launch(stats, getattr(_lib(), entry), x, x.data_ptr(), y.data_ptr(), x.shape[0],
            col.logn, lp.B.bit_length() - 1, *(t.data_ptr() for t in tables),
            lp.tile.bit_length() - 1, lp.q, (1 << 64) // lp.q, *scale, int(col.xnp))
    return y


def merge_u64_large_colfwd(x: torch.Tensor, lp: LargePlan) -> torch.Tensor:
    """K7 forward on a contiguous (batch, A * B) tensor."""
    return _col(COLFWD, "merge_u64_large_colfwd", x, lp, inverse=False)


def merge_u64_large_colinv(x: torch.Tensor, lp: LargePlan) -> torch.Tensor:
    """K7 inverse on a contiguous (batch, A * B) tensor."""
    return _col(COLINV, "merge_u64_large_colinv", x, lp, inverse=True)


def rowmat(stats: KernelStats, x: torch.Tensor, plan: MergePlan,
           inverse: bool) -> torch.Tensor:
    """merge_u64_large_rowmat with its launch counted under `stats` (the
    4-step's rows count under K10, hopper_fourstep.py)."""
    if not (plan.is64 and plan.q < (1 << 62) and 1 <= plan.logn <= 9):
        raise NTTDispatchError(
            f"merge_u64_large_rowmat takes u64 row plans with q < 2^62 and "
            f"logn 1-9, got q={plan.q} logn={plan.logn} is64={plan.is64}")
    _check(x, plan.n, plan.device)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return rowmat_plain(x, plan, inverse)
    table, shoup = ((plan.inv_table, plan.inv_shoup) if inverse
                    else (plan.fwd_table, plan.fwd_shoup))
    y = torch.empty_like(x)
    _launch(stats, _lib().merge_u64_large_rowmat, x, x.data_ptr(), y.data_ptr(),
            x.shape[0], plan.logn, table.data_ptr(), shoup.data_ptr(), plan.q,
            (1 << 64) // plan.q, plan.n_inv, plan.n_inv_shoup, int(inverse),
            int(plan.xnp))
    return y


def merge_u64_large_rowmat(x: torch.Tensor, plan: MergePlan, inverse: bool) -> torch.Tensor:
    """K8 on a contiguous (rows, B) tensor, B = 2..512, with the B-point
    row plan: the forward merge NTT of every row, or its inverse."""
    return rowmat(ROWMAT, x, plan, inverse)


# --------------------------------------------------------------- composition


class _Steps(NamedTuple):
    colfwd: Any
    colinv: Any
    rowmat: Any
    fwd: Any          # rows of 2^11..2^17 (K1)
    inv: Any          # (K2)
    polymul_inv: Any  # (K3)


KERNEL_STEPS = _Steps(merge_u64_large_colfwd, merge_u64_large_colinv,
                      merge_u64_large_rowmat, hm.merge_u64_fwd, hm.merge_u64_inv,
                      hm.merge_u64_polymul_inv)
PLAIN_STEPS = _Steps(colfwd_plain, colinv_plain, rowmat_plain, hm.merge_u64_fwd_plain,
                     hm.merge_u64_inv_plain, hm.merge_u64_polymul_inv_plain)


def _rows(y, lp: LargePlan, inverse: bool, steps: _Steps):
    r = y.reshape(y.shape[0] * lp.A, lp.B)
    if lp.nested is not None:
        out = _transform(r, lp.nested, inverse, steps)
    elif lp.row_kernel == "K8":
        out = steps.rowmat(r, lp.rows, inverse)
    else:
        out = (steps.inv if inverse else steps.fwd)(r, lp.rows)
    return out.reshape(y.shape)


def _transform(x, lp: LargePlan, inverse: bool, steps: _Steps):
    if inverse:
        return steps.colinv(_rows(x, lp, True, steps), lp)
    return _rows(steps.colfwd(x, lp), lp, False, steps)


def _polymul_inv(fa, fb, lp: LargePlan, steps: _Steps):
    if not lp.fuses_product:
        raise ValueError("the fused polymul needs rows of 2^11..2^16 words")
    rows = (fa.shape[0] * lp.A, lp.B)
    y = steps.polymul_inv(fa.reshape(rows), fb.reshape(rows), lp.rows)
    return steps.colinv(y.reshape(fa.shape), lp)


def merge_u64_large(x: torch.Tensor, lp: LargePlan, inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse) merged NTT of each row of a contiguous
    (batch, N) tensor, through the kernels (pallas_mxu_large_u64)."""
    return _transform(x, lp, inverse, KERNEL_STEPS)


def merge_u64_large_polymul_inv(fa: torch.Tensor, fb: torch.Tensor,
                                lp: LargePlan) -> torch.Tensor:
    """INTT(fa o fb) with the product fused into K3's row inverse
    (pallas_mxu_large_polymul_inv); `lp.fuses_product` plans only."""
    return _polymul_inv(fa, fb, lp, KERNEL_STEPS)


def merge_u64_large_plain(x: torch.Tensor, lp: LargePlan, inverse: bool = False):
    """merge_u64_large through the plain versions only, on any device."""
    return _transform(x, lp, inverse, PLAIN_STEPS)


def merge_u64_large_polymul_inv_plain(fa, fb, lp: LargePlan):
    return _polymul_inv(fa, fb, lp, PLAIN_STEPS)


# dispatch's entries: a MergePlan, its big-ring plan cached on it
def merge_u64_large_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    return merge_u64_large(x, large_plan(plan))


def merge_u64_large_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    return merge_u64_large(x, large_plan(plan), inverse=True)

