"""The factored merge NTT's plan, and K17's Hopper kernel with its plain version.

The counterpart of the JAX package's ops/pallas_merge.py.  Its kernels
view a ring of N = A * 128 words as an (A, 128) matrix and use the
identity its module docstring derives:

    merge_ntt(x).reshape(A, 128) = rowNTT_128( W o colNTT_A( x.reshape(A, 128) ) )

colNTT_A is the merge network's first log A stages (they pair rows and
run down the columns), W[a, b] = psi^((2 bitrev(a) + 1) b) for X^N + 1
and omega^(bitrev(a) b) for X^N - 1, and rowNTT_128 one 128-point merge
NTT, the same for every row.  The inverse mirrors it: the row inverse,
W^-1, the column inverse, n^-1.

`KernelMergePlan` holds those tables (JAX's `KernelMergePlan`,
pallas_merge.py:62-143) as int64 tensors on its device, each with its
Shoup companion: the column prefix of the bit-reversed table (2A entries
for X^N + 1, A for X^N - 1), the 64-entry row table, n^-1, and the
(A, 128) W table of each direction, built at its first use with its
companion interleaved, as the kernels read it: an (A, 128, 2) tensor of
(entry, companion) pairs for u64 (256 MiB at logn 24), one packed word
entry | companion << 32 a position for u32.  `kernel_plan(merge_plan)`
builds it once per MergePlan and caches it there, as the JAX package
caches its plan on the parameters (gpuntt_tpu/ops/merge_ntt.py:246-256).

K17 (`pallas_merge_u32`, pallas_merge.py:313) has its counterpart here:

    kmerge_u32(x, plan)                <- _fwd_kernel_u32 (pallas_merge.py:218)
    kmerge_u32(x, plan, inverse=True)  <- _inv_kernel_u32 (pallas_merge.py:255)

on a contiguous (batch, N) int64 tensor of u32 values, u32 plans with
q < 2^30 (its lazy butterflies keep values below 4q < 2^32) and logn
7-25 (`FAMILY`): the bit-reversed merge NTT in canonical residues, and
its inverse with n^-1.  No dispatch route calls it, as in the JAX
package; its u64 twin K15 is hopper_kmerge64.py's.  Both run on
csrc/kmerge.cu (see the note there), called through `kmerge`.  On a CPU
tensor a wrapper runs the kernel's plain version, and only there; on a
CUDA tensor it launches the kernel (through ops/kernel.py) or raises.
Every launch adds one to its kernel's `launches`, every plain-version
call through a wrapper one to `plain_calls`; `tracing.reset()` zeroes
them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..common.errors import NTTDispatchError
from ..common.tracing import KernelStats
from ..params.bitrev import bitrev_permute, bitreverse_indices
from ..params.merge import NTTParameters, ReductionPolynomial
from . import barrett as bo
from . import kernel
from .hopper_merge_large import pows
from .limb import from_numpy_u64, signed
from .merge_ntt import MergePlan, butterfly_ops, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/kmerge.cu"
LANES = 128
LOG_LANES = 7
# K17: lazy butterflies, 4q < 2^32; no route calls it, as in the JAX package
FAMILY = kernel.Family(word=32, q_bits=30, takes=(7, 25), routes=None)

FORWARD = KernelStats("kmerge_u32_forward", "gpuntt_tpu/ops/pallas_merge.py:218",
                      source=SOURCE)
INVERSE = KernelStats("kmerge_u32_inverse", "gpuntt_tpu/ops/pallas_merge.py:255",
                      source=SOURCE)
KERNELS = (FORWARD, INVERSE)


# ---------------------------------------------------------------- tables


def _w_table(root: int, q: int, A: int, xnp: bool) -> np.ndarray:
    """The (A, 128) W of `root`: row a is the powers of
    root^(2 bitrev(a) + 1) (X^N + 1) or root^bitrev(a) (X^N - 1), in one
    call of the native core where it is built, else a row at a time."""
    from .. import _native

    if not _native.available():
        br = bitreverse_indices(A.bit_length() - 1)
        return np.stack([pows(pow(root, 2 * int(e) + 1 if xnp else int(e), q), q, LANES)
                         for e in br])
    if not xnp:
        return _native.w_table_forward(root, q, A, LANES).reshape(A, LANES)
    # psi^((2 br(a) + 1) b) = (psi^2)^(br(a) b) * psi^b
    even = _native.w_table_forward(root * root % q, q, A, LANES).reshape(A, LANES)
    return _native.pointwise_mult(even, np.broadcast_to(pows(root, q, LANES), (A, LANES)), q)


@dataclass(frozen=True, eq=False)
class KernelMergePlan:
    """Twiddle tables laid out for the factored kernels, as int64 tensors
    on `device` with their Shoup companions (`*_s`).  `root`/`iroot` are
    the root pair the W tables are built from at their first use (`w`);
    a plan carried across with `from_arrays` holds its W tables already."""

    logn: int
    q: int
    is64: bool
    xnp: bool
    n_inv: int
    n_inv_s: int
    col_fwd: torch.Tensor   # (2A,) X^N + 1, (A,) X^N - 1: the bit-reversed table's prefix
    col_fwd_s: torch.Tensor
    row_fwd: torch.Tensor   # (64,) the 128-point row NTT's bit-reversed table
    row_fwd_s: torch.Tensor
    col_inv: torch.Tensor
    col_inv_s: torch.Tensor
    row_inv: torch.Tensor
    row_inv_s: torch.Tensor
    device: torch.device
    root: int | None = None
    iroot: int | None = None
    # direction (False forward, True inverse) -> W with its companion in
    # the kernels' layout (w_kernel)
    _w: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def A(self) -> int:
        return self.n >> LOG_LANES

    @property
    def word(self) -> int:
        return 64 if self.is64 else 32

    @staticmethod
    def from_params(p: NTTParameters, device=None) -> "KernelMergePlan":
        """The plan of `p` (JAX's KernelMergePlan.from_params).  `device`
        defaults to the first CUDA card (NTTDeviceError without one)."""
        return KernelMergePlan.from_root(
            p.modulus.value, p.logn, p.poly_reduction, p.root_of_unity,
            p.inverse_root_of_unity, p.n_inv, device=device, dtype=p.dtype)

    @staticmethod
    def from_root(q: int, logn: int, poly, root: int, iroot: int, n_inv: int,
                  device=None, dtype=np.uint64) -> "KernelMergePlan":
        """The plan from the root pair: root is psi (X^N + 1) or omega
        (X^N - 1), iroot its inverse.  Raises NTTDispatchError below
        logn 7, where JAX's from_params asserts A >= 1."""
        if logn < LOG_LANES:
            raise NTTDispatchError(
                f"the factored kernels need N >= 128 (A = N / 128 >= 1), got logn={logn}")
        xnp = ReductionPolynomial(getattr(poly, "value", poly)) == ReductionPolynomial.X_N_plus
        A = 1 << (logn - LOG_LANES)

        def col(r):
            # the first 2A (A) entries of the bit-reversed table of N (N/2)
            # powers of r: r^(bitrev(i, log size)) = (r^64)^bitrev(i, log len)
            return bitrev_permute(pows(pow(r, 64, q), q, 2 * A if xnp else A))

        def row(r):
            # the 128-point row NTT's root: psi^(2A) or omega^A
            return bitrev_permute(pows(pow(r, 2 * A if xnp else A, q), q, LANES // 2))

        return KernelMergePlan._build(
            q, logn, xnp, np.dtype(dtype) == np.uint64, n_inv, col(root), row(root),
            col(iroot), row(iroot), device, root=root, iroot=iroot)

    @staticmethod
    def from_arrays(logn: int, q: int, is64: bool, xnp: bool, col_fwd, w_fwd, row_fwd,
                    col_inv, w_inv, row_inv, n_inv: int, device=None) -> "KernelMergePlan":
        """The plan from a JAX KernelMergePlan's numpy fields (uint64
        arrays, W of shape (A, 128)): the converter that carries it across.
        The companions are derived here."""
        plan = KernelMergePlan._build(q, logn, xnp, is64, n_inv, col_fwd, row_fwd, col_inv,
                                      row_inv, device)
        for inverse, w in ((False, w_fwd), (True, w_inv)):
            plan._w[inverse] = plan._w_layout(np.asarray(w, dtype=np.uint64).reshape(plan.A, LANES))
        return plan

    @staticmethod
    def _build(q, logn, xnp, is64, n_inv, col_fwd, row_fwd, col_inv, row_inv, device,
               **roots) -> "KernelMergePlan":
        from ..common.device import default_device

        device = torch.device(device) if device is not None else default_device()
        word = 64 if is64 else 32
        proto = KernelMergePlan(
            logn=int(logn), q=int(q), is64=bool(is64), xnp=bool(xnp), n_inv=int(n_inv),
            n_inv_s=(int(n_inv) << word) // int(q), device=device,
            **{f: None for f in ("col_fwd", "col_fwd_s", "row_fwd", "row_fwd_s",
                                 "col_inv", "col_inv_s", "row_inv", "row_inv_s")}, **roots)
        fields = {}
        for name, table in (("col_fwd", col_fwd), ("row_fwd", row_fwd), ("col_inv", col_inv),
                            ("row_inv", row_inv)):
            fields[name], fields[name + "_s"] = proto._pair(np.asarray(table, dtype=np.uint64))
        return dataclasses.replace(proto, **fields)

    def _pair(self, table: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """`table` and its Shoup companion as int64 tensors on the device."""
        comp = bo.shoup_companion(table, self.q, self.word).astype(np.uint64)
        return from_numpy_u64(table, self.device), from_numpy_u64(comp, self.device)

    def _w_layout(self, table: np.ndarray) -> torch.Tensor:
        """An (A, 128) W table with its Shoup companion in the kernels'
        layout: u64 (A, 128, 2) (entry, companion) pairs, one 16-byte load
        a word; u32 (A, 128) words entry | companion << 32, one 8-byte
        load a word."""
        comp = bo.shoup_companion(table, self.q, self.word).astype(np.uint64)
        if self.is64:
            return from_numpy_u64(np.stack((table, comp), -1), self.device)
        return from_numpy_u64(table | (comp << np.uint64(32)), self.device)

    def w_kernel(self, inverse: bool) -> torch.Tensor:
        """W of a direction with its companion in the kernels' layout
        (`_w_layout`), built on first call and kept."""
        if inverse not in self._w:
            root = self.iroot if inverse else self.root
            self._w[inverse] = self._w_layout(_w_table(root, self.q, self.A, self.xnp))
        return self._w[inverse]

    def w(self, inverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """The (A, 128) W table of a direction and its companion: views
        of `w_kernel` (u64), or unpacked from it (u32)."""
        wk = self.w_kernel(inverse)
        if self.is64:
            return wk[..., 0], wk[..., 1]
        return wk & 0xFFFFFFFF, (wk >> 32) & 0xFFFFFFFF  # >> is arithmetic on int64

    def tables(self, inverse: bool) -> tuple[torch.Tensor, ...]:
        """(col, col_s, W, row, row_s) of a direction, W in the kernels'
        layout: the kernels' argument order."""
        wk = self.w_kernel(inverse)
        if inverse:
            return self.col_inv, self.col_inv_s, wk, self.row_inv, self.row_inv_s
        return self.col_fwd, self.col_fwd_s, wk, self.row_fwd, self.row_fwd_s

    def device_bytes(self) -> int:
        """Bytes of the tables this plan holds now (W only once built)."""
        ts = [getattr(self, f.name) for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)]
        ts += list(self._w.values())
        return sum(t.numel() * t.element_size() for t in ts)


def kernel_plan(plan: MergePlan) -> KernelMergePlan:
    """The factored kernels' plan of a MergePlan, on its device, built on
    first call and cached on it."""
    if "kmerge" not in plan._lazy:
        plan._lazy["kmerge"] = KernelMergePlan.from_root(
            plan.q, plan.logn, plan.reduction_poly, plan.root, plan.iroot, plan.n_inv,
            device=plan.device, dtype=np.uint64 if plan.is64 else np.uint32)
    return plan._lazy["kmerge"]


# ------------------------------------------------------------ plain version


def kmerge_plain(x: torch.Tensor, plan: KernelMergePlan, inverse: bool = False):
    """What the factored kernels compute, in torch ops on any device: x
    mod q, then the column stages (the merge network's first log A stages,
    on the column prefix), W, the 128-point row NTT; or the mirror with
    n^-1 last.  Every stage keeps canonical residues, as the kernels'
    canonical u64 instance does; their lazy instances reach the same
    residues at the end of each launch."""
    ops, b, A = butterfly_ops(plan.q, plan.is64), x.shape[0], plan.A
    x = (bo.reduce_forced64 if plan.is64 else bo.reduce_forced32)(x, plan.q)
    col, col_s, _, row, row_s = plan.tables(inverse)
    w, ws = plan.w(inverse)
    if not inverse:
        y = ct_stages(x, col, col_s, ops, plan.logn, plan.xnp, range(plan.logn - LOG_LANES))
        y = ops.mulc(y.reshape(b, A, LANES), w, ws)
        return ct_stages(y, row, row_s, ops, LOG_LANES, False).reshape(b, plan.n)
    y = gs_stages(x.reshape(b, A, LANES), row, row_s, ops, LOG_LANES, False)
    y = ops.mulc(y, w, ws).reshape(b, plan.n)
    y = gs_stages(y, col, col_s, ops, plan.logn, plan.xnp,
                  range(plan.logn - LOG_LANES - 1, -1, -1))
    return ops.mulc(y, plan.n_inv, signed(plan.n_inv_s))


# ------------------------------------------------------------------ wrappers


def kmerge(family: kernel.Family, stats: KernelStats, x: torch.Tensor, plan: KernelMergePlan,
           inverse: bool) -> torch.Tensor:
    """One call of csrc/kmerge.cu's entry `stats.name` on a (batch, N)
    tensor, batch >= 1, for a plan `family` takes."""
    family.admit(stats.name, plan.is64, plan.q, plan.logn)
    kernel.check(stats.name, (plan.n,), plan.device, x)
    if x.shape[0] < 1:
        raise NTTDispatchError(f"{stats.name} takes a batch of one row or more")
    return kernel.call(stats, (x,), kmerge_plain, (x, plan, inverse), stats.name, lambda: (
        plan.logn, *(t.data_ptr() for t in plan.tables(inverse)), plan.q,
        (1 << plan.word) // plan.q, *((plan.n_inv, plan.n_inv_s) if inverse else ()),
        int(plan.xnp)))


def kmerge_u32(x: torch.Tensor, plan: KernelMergePlan, inverse: bool = False) -> torch.Tensor:
    """K17's counterpart (pallas_merge_u32): the merged NTT of each row of
    a (batch, N) tensor of u32 values, bit-reversed output order, or with
    inverse=True its inverse with n^-1; canonical output, any u32 input
    word reduced mod q first.  u32 plans with q < 2^30, logn 7-25."""
    return kmerge(FAMILY, INVERSE if inverse else FORWARD, x, plan, inverse)
