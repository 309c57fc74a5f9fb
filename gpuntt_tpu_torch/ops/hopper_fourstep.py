"""Hopper kernels of the 4-step NTT (u64 and u32, logn 12-24), their plain
versions, the kernel plan and the composition.

The counterpart of the JAX package's ops/pallas_mxu_4step.py.  A ring of
N = n1 * n2 words arrives pre-transposed as an (n2, n1) matrix, and the
transform is two phases (ops/fourstep.py has the calling convention):

1. the column phase: the n1-point NTT of each row (the inverse: its
   unscaled Gentleman-Sande inverse), a transpose to (n1, n2), and the
   twiddle matrix W (W^-1), factored as an (n1, Tw) tile table times a
   per-tile scale (n2 / Tw, n1), so no N-entry table exists;
2. the row phase: the n2-point NTT of each of the n1 rows (the inverse
   with the full N^-1 folded in).

Both small transforms are X^n - 1 merge networks whatever the ring's
polynomial: the reference's core_ntt reads table[0:m] for every
polynomial, so for X^N + 1 the column root psi^(N / n1) is a 2 n1-th
root used with cyclic indexing.  Four Pallas kernels are replaced:

    fourstep_u64_col  <- _col_kernel   (K9,  :203)  csrc/fourstep.cu
    fourstep_u64_row  <- _row_kernel   (K10, :213)  csrc/merge_u64_large.cu
    fourstep_u32_col  <- _col_kernel32 (K11, :483)  csrc/fourstep.cu
    fourstep_u32_row  <- _row_kernel32 (K11, :492)  csrc/merge_u32.cu

K9 and K11's column twin are new kernels (fourstep.cu).  K10 computes
what K8 computes — whole rows of <= 512 words, a forward CT, or a GS
inverse followed by n_inv — so its wrapper reaches K8's library entry,
merge_u64_large_rowmat, with the 4-step's n2-point sub-plan (n_inv =
N^-1), and counts under K10's stats.  K11's row twin is likewise the u32
family of merge_u32.cu at logn 7-9 (one launch over whole rings;
hopper_merge32.takes), counted under its own stats.  Rows above 512
words run, as the JAX route delegates them (pallas_mxu_4step.py:155-157,
:442-444), on K1/K2 (u64, 2^11..2^17 words) or the u32 family (2^10..
2^25), and count under those kernels' stats.

Each wrapper takes a contiguous int64 tensor and a plan on the same
device.  On a CPU tensor it runs the kernel's plain version, and only
there; on a CUDA tensor it launches the kernel or raises.  Every launch
adds one to its kernel's `launches`, every plain-version call through a
wrapper one to `plain_calls`; `reset_counts()` zeroes both.
`fourstep_plain` composes the plain versions alone, on any device, which
is how the kernels are checked on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from ..params.bitrev import bitreverse, bitreverse_indices
from ..params.merge import ReductionPolynomial
from . import barrett as bo
from . import hopper_merge as hm
from . import hopper_merge32 as hm32
from . import hopper_merge_large as hml
from .hopper_merge import KernelStats, _launch
from .limb import from_numpy_u64
from .merge_ntt import MergePlan, merge_intt_lanes, merge_ntt_lanes

SOURCE = "gpuntt_tpu_torch/csrc/fourstep.cu"

ROW_MAT_MAX = 512  # K10 / K11's row twin take rows of <= 512 words
COL_MAX = 512      # the column kernels take n1 <= 512

COL64 = KernelStats("fourstep_u64_col", "gpuntt_tpu/ops/pallas_mxu_4step.py:203",
                    source=SOURCE)
ROW64 = KernelStats("fourstep_u64_row", "gpuntt_tpu/ops/pallas_mxu_4step.py:213",
                    source=hml.SOURCE)
COL32 = KernelStats("fourstep_u32_col", "gpuntt_tpu/ops/pallas_mxu_4step.py:483",
                    source=SOURCE)
ROW32 = KernelStats("fourstep_u32_row", "gpuntt_tpu/ops/pallas_mxu_4step.py:492",
                    source=hm32.SOURCE)
KERNELS = (COL64, ROW64, COL32, ROW32)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def rows_have_kernel(n2: int, is64: bool) -> bool:
    """Rows of n2 words have a kernel: u64 n2 <= 512 (K10) or 2^11..2^17
    (K1/K2); u32 2^7..2^25 (the u32 family)."""
    if is64:
        return n2 <= ROW_MAT_MAX or 1 << 11 <= n2 <= 1 << 17
    return 1 << 7 <= n2 <= 1 << 25


def covers(plan) -> bool:
    """FourStepPlans whose transforms the 4-step route sends to the
    kernels: a genuine root at full size (order N for X^N - 1, 2N for
    X^N + 1, as pallas_mxu_4step.py:94-97 checks), u64 with q < 2^62 or
    u32 with q < 2^30, logn 12-24, n1 <= 512 and rows with a kernel."""
    order = 2 * plan.n if plan.poly == ReductionPolynomial.X_N_plus else plan.n
    return (pow(plan.root, order, plan.q) == 1 and plan.root * plan.iroot % plan.q == 1
            and plan.q < 1 << (62 if plan.is64 else 30) and 12 <= plan.logn <= 24
            and plan.n1 <= COL_MAX and rows_have_kernel(plan.n2, plan.is64))


# ------------------------------------------------------------------- plan


def _shoup_pair(table: np.ndarray, q: int, word: int, device):
    table = np.ascontiguousarray(table, dtype=np.uint64)
    return (from_numpy_u64(table, device),
            from_numpy_u64(bo.shoup_companion(table, q, word), device))


@dataclass(frozen=True, eq=False)
class FourStepKernelPlan:
    """The column sub-plan, the factored W tables with their Shoup
    companions, and the row sub-plan, built from exponent algebra over
    the root pair.  `tile` is the column kernel's block of rows (T * n1 =
    2^12 u64 or 2^13 u32 words, 32 KiB); `w_tile` the W factoring's Tw =
    2^ceil(log n2 / 2), which keeps both factors near sqrt(n2) * n1
    entries (at the kernel's own T = 16, the u64 2^24 scale tables alone
    would be 32 MiB)."""

    logn: int
    q: int
    n1: int
    n2: int
    is64: bool
    tile: int
    w_tile: int
    col: MergePlan  # n1-point X^n1 - 1, root^(N / n1)
    wt_fwd: torch.Tensor  # (n1, Tw)
    wt_fwd_shoup: torch.Tensor
    ws_fwd: torch.Tensor  # (n2 / Tw, n1)
    ws_fwd_shoup: torch.Tensor
    wt_inv: torch.Tensor
    wt_inv_shoup: torch.Tensor
    ws_inv: torch.Tensor
    ws_inv_shoup: torch.Tensor
    rows: MergePlan  # n2-point X^n2 - 1, root^(N / n2), n_inv = N^-1

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def device(self) -> torch.device:
        return self.col.device

    @property
    def row_kernel(self) -> str:
        """What runs the rows: "K10", "K11-row", "K1" (with K2) or "u32"
        (the u32 family, counted by its logn as K4-K6)."""
        if self.n2 <= ROW_MAT_MAX:
            return "K10" if self.is64 else "K11-row"
        return "K1" if self.is64 else "u32"

    @staticmethod
    def from_spec(q: int, logn: int, n1: int, n2: int, root: int, iroot: int, n_inv: int,
                  is64: bool = True, device=None) -> "FourStepKernelPlan":
        """The kernels' plan of a 4-step transform given its field spec:
        `root`/`iroot` the full-size pair (omega for X^N - 1, psi for
        X^N + 1), `n_inv` the whole inverse scaling."""
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        dtype, word = (np.uint64, 64) if is64 else (np.uint32, 32)
        log1, log2 = n1.bit_length() - 1, n2.bit_length() - 1
        n = 1 << logn
        tile = min(n2, (1 << (12 if is64 else 13)) >> log1)
        w_tile = 1 << ((log2 + 1) // 2)
        logw, nt = w_tile.bit_length() - 1, n2 // w_tile
        col = hml._merge_plan(q, log1, False, pow(root, n // n1, q), pow(iroot, n // n1, q),
                              pow(n1, q - 2, q), device, dtype)
        rows = hml._merge_plan(q, log2, False, pow(root, n1, q), pow(iroot, n1, q), n_inv,
                               device, dtype)
        # forward W[i, j] = root^(br(i) j): tile w_i^t, scale w_i^(jt Tw)
        wt_f, ws_f = hml._w_factor([pow(root, bitreverse(i, log1), q) for i in range(n1)],
                                   w_tile, n2, q)
        # inverse W[i, j] = iroot^(i br(j)); with j = jt Tw + t,
        # br(j) = br(t, log Tw) nt + br(jt, log nt): tile v_i^(br(t) nt),
        # scale v_i^br(jt), v_i = iroot^i
        bt, bs = bitreverse_indices(logw), bitreverse_indices(log2 - logw)
        inv_bases = [pow(iroot, i, q) for i in range(n1)]
        wt_i = np.stack([hml._pows(pow(v, nt, q), q, w_tile)[bt] for v in inv_bases])
        ws_i = np.stack([hml._pows(v, q, nt)[bs] for v in inv_bases], axis=1)
        (wtf, wtfs), (wsf, wsfs), (wti, wtis), (wsi, wsis) = (
            _shoup_pair(t, q, word, device) for t in (wt_f, ws_f, wt_i, ws_i))
        return FourStepKernelPlan(
            logn=logn, q=q, n1=n1, n2=n2, is64=is64, tile=tile, w_tile=w_tile, col=col,
            wt_fwd=wtf, wt_fwd_shoup=wtfs, ws_fwd=wsf, ws_fwd_shoup=wsfs, wt_inv=wti,
            wt_inv_shoup=wtis, ws_inv=wsi, ws_inv_shoup=wsis, rows=rows)

    def to(self, device) -> "FourStepKernelPlan":
        """This plan with every table on `device`."""
        return hml.plan_to(self, device)

    def device_bytes(self) -> int:
        """Bytes of every table this plan holds, sub-plans included."""
        return hml.plan_bytes(self)


def kernel_plan(plan) -> FourStepKernelPlan:
    """The kernels' plan of a FourStepPlan, built on its device at first
    use and cached on it (its W tables are never read)."""
    if "kernel" not in plan._lazy:
        plan._lazy["kernel"] = FourStepKernelPlan.from_spec(
            plan.q, plan.logn, plan.n1, plan.n2, plan.root, plan.iroot, plan.n_inv,
            plan.is64, device=plan.device)
    return plan._lazy["kernel"]


# ------------------------------------------------------------ plain versions


def _twist(y, wt, wts, ws, wss, kp: FourStepKernelPlan):
    """y (batch, n1, n2) times W[i, j] = wt[i, j % Tw] * ws[j // Tw, i]."""
    mulc = kp.rows.ops().mulc
    v = y.reshape(y.shape[0], kp.n1, kp.n2 // kp.w_tile, kp.w_tile)
    v = mulc(v, wt[:, None, :], wts[:, None, :])
    return mulc(v, ws.t()[:, :, None], wss.t()[:, :, None])


def col_plain(x, kp: FourStepKernelPlan, inverse: bool):
    """K9 / K11's column twin: x mod q as (batch, n2, n1), the n1-point
    NTT of each row (inverse: the unscaled GS inverse), transposed to
    (batch, n1, n2), then W (inverse: W^-1); flattened."""
    batch = x.shape[0]
    reduce = bo.reduce_forced64 if kp.is64 else bo.reduce_forced32
    v = reduce(x, kp.q).view(batch, kp.n2, kp.n1)
    if inverse:
        v = merge_intt_lanes(v, kp.col, scale=False)
        tabs = (kp.wt_inv, kp.wt_inv_shoup, kp.ws_inv, kp.ws_inv_shoup)
    else:
        v = merge_ntt_lanes(v, kp.col)
        tabs = (kp.wt_fwd, kp.wt_fwd_shoup, kp.ws_fwd, kp.ws_fwd_shoup)
    return _twist(v.transpose(1, 2), *tabs, kp).reshape(batch, kp.n)


def row32_plain(x, plan: MergePlan, inverse: bool):
    """K11's row twin: x mod q, then the n2-point merge NTT of every row
    (or its inverse, n_inv folded)."""
    return (hm32.merge_u32_inv_plain if inverse else hm32.merge_u32_fwd_plain)(x, plan)


# ------------------------------------------------------------------ wrappers


def _check(x: torch.Tensor, n: int, device: torch.device) -> None:
    if (x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != n
            or not x.is_contiguous() or x.device != device):
        raise NTTDispatchError(
            f"expected a contiguous (batch, {n}) int64 tensor on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    if x.device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no fourstep kernel for {x.device}")


def _lib():
    from ._build import library

    return library("fourstep")


def _col(stats: KernelStats, x, kp: FourStepKernelPlan, inverse: bool, is64: bool):
    if kp.is64 != is64 or kp.n1 > COL_MAX:
        raise NTTDispatchError(
            f"{stats.name} takes {'u64' if is64 else 'u32'} plans with n1 <= {COL_MAX}, "
            f"got is64={kp.is64} n1={kp.n1}")
    _check(x, kp.n, kp.device)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return col_plain(x, kp, inverse)
    col = kp.col
    tables = ((col.inv_table, col.inv_shoup, kp.wt_inv, kp.wt_inv_shoup, kp.ws_inv,
               kp.ws_inv_shoup) if inverse else
              (col.fwd_table, col.fwd_shoup, kp.wt_fwd, kp.wt_fwd_shoup, kp.ws_fwd,
               kp.ws_fwd_shoup))
    entry = f"fourstep_{'u64' if is64 else 'u32'}_col_{'inv' if inverse else 'fwd'}"
    y = torch.empty_like(x)
    _launch(stats, getattr(_lib(), entry), x, x.data_ptr(), y.data_ptr(), x.shape[0],
            kp.n1.bit_length() - 1, kp.n2.bit_length() - 1, kp.tile.bit_length() - 1,
            kp.w_tile.bit_length() - 1, *(t.data_ptr() for t in tables), kp.q,
            (1 << (64 if is64 else 32)) // kp.q)
    return y


def fourstep_u64_col(x: torch.Tensor, kp: FourStepKernelPlan, inverse: bool) -> torch.Tensor:
    """K9 on a contiguous (batch, N) tensor in the (n2, n1) layout; the
    result in the (n1, n2) layout."""
    return _col(COL64, x, kp, inverse, True)


def fourstep_u32_col(x: torch.Tensor, kp: FourStepKernelPlan, inverse: bool) -> torch.Tensor:
    """K11's column twin, as fourstep_u64_col on u32 values."""
    return _col(COL32, x, kp, inverse, False)


def fourstep_u64_row(x: torch.Tensor, plan: MergePlan, inverse: bool) -> torch.Tensor:
    """K10 on a contiguous (rows, n2) tensor, n2 <= 512, with the n2-point
    row plan: K8's library entry, counted under K10."""
    return hml.rowmat(ROW64, x, plan, inverse)


def fourstep_u32_row(x: torch.Tensor, plan: MergePlan, inverse: bool) -> torch.Tensor:
    """K11's row twin on a contiguous (rows, n2) tensor, n2 = 128..512:
    merge_u32.cu's entries at logn 7-9, counted under K11's row stats."""
    if not 7 <= plan.logn <= 9:
        raise NTTDispatchError(f"{ROW32.name} takes rows of 128-512 words, got 2^{plan.logn}")
    return (hm32.inverse if inverse else hm32.forward)(ROW32, x, plan)


# --------------------------------------------------------------- composition


class _Steps(NamedTuple):
    col: Any  # (x, kp, inverse)
    row: Any  # rows <= 512: (x, rows plan, inverse)
    fwd: Any  # longer rows: (x, rows plan)
    inv: Any


KERNEL_STEPS = {
    True: _Steps(fourstep_u64_col, fourstep_u64_row, hm.merge_u64_fwd, hm.merge_u64_inv),
    False: _Steps(fourstep_u32_col, fourstep_u32_row, hm32.merge_u32_fwd,
                  hm32.merge_u32_inv),
}
PLAIN_STEPS = {
    True: _Steps(col_plain, hml.rowmat_plain, hm.merge_u64_fwd_plain,
                 hm.merge_u64_inv_plain),
    False: _Steps(col_plain, row32_plain, hm32.merge_u32_fwd_plain,
                  hm32.merge_u32_inv_plain),
}


def _transform(x, kp: FourStepKernelPlan, inverse: bool, steps: _Steps):
    r = steps.col(x, kp, inverse).view(x.shape[0] * kp.n1, kp.n2)
    if kp.n2 <= ROW_MAT_MAX:
        out = steps.row(r, kp.rows, inverse)
    else:
        out = (steps.inv if inverse else steps.fwd)(r, kp.rows)
    return out.view(x.shape)


def fourstep(x: torch.Tensor, kp: FourStepKernelPlan, inverse: bool = False) -> torch.Tensor:
    """The 4-step transform of each row of a contiguous (batch, N) tensor
    in the lanes convention, through the kernels (fourstep_mxu_lanes)."""
    return _transform(x, kp, inverse, KERNEL_STEPS[kp.is64])


def fourstep_plain(x: torch.Tensor, kp: FourStepKernelPlan, inverse: bool = False):
    """fourstep through the plain versions only, on any device."""
    return _transform(x, kp, inverse, PLAIN_STEPS[kp.is64])
