"""The port's one kernel-call layer, between the Hopper wrappers
(ops/hopper_*.py) and the kernel libraries (ops/_build.py) with the
spans (common/tracing.py).

Every wrapper calls its kernel through the same four steps, each
defined here once:

- `Family.admit` refuses a plan the family's kernels do not take.  Each
  family declares its limits once, as a `Family` record in its module:
  the word its values are held in, the bound on q, the logn range its
  kernels take and the range dispatch routes to them.  The register
  passes' lazy butterflies (csrc/radix.cuh) hold values below 4q, which
  must fit the word: so q < 2^62 on 64-bit words (K15's canonical
  instance takes q < 2^63), q < 2^30 on 32-bit ones, and
  `covers`/`takes` of the family modules read the same records;
- `check` refuses an operand the kernels do not take;
- `call` is the CPU-or-card choice: on a CPU operand the family's plain
  version runs, and only there, counted under the kernel's
  `plain_calls`; on a card the output is allocated and the C entry of
  the library built from the kernel's `source` is launched;
- `launch` is the one function every C entry passes through: the
  ntt.launch span site, the current stream, the return code and the
  kernel's `launches`.

`library` is the one seam to the built libraries: a library is built
and loaded at its first launch, never when a module is imported.  This
module imports no family module.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import torch

from ..common import tracing
from ..common.errors import NTTDeviceError, NTTDispatchError
from ..common.tracing import KernelStats
from ._build import library

INT64 = (torch.int64,)


@dataclass(frozen=True)
class Family:
    """A kernel family's limits: values held in `word`-bit words (64 or
    32), q < 2^`q_bits`, rings of 2^logn for logn in the inclusive range
    `takes` (None: whatever ring the family's plans hold), and the range
    `routes` that dispatch sends to the family (None: no route sends
    plans to it directly)."""

    word: int
    q_bits: int
    takes: tuple[int, int] | None
    routes: tuple[int, int] | None

    def takes_ring(self, logn: int) -> bool:
        """Whether the kernels take rings of 2^logn words."""
        return self.takes is None or self.takes[0] <= logn <= self.takes[1]

    def admits(self, is64: bool, q: int, logn: int) -> bool:
        """Whether the kernels take a plan of 64-bit (`is64`) or 32-bit
        words, largest modulus q and rings of 2^logn."""
        return is64 == (self.word == 64) and q < 1 << self.q_bits and self.takes_ring(logn)

    def covers(self, is64: bool, q: int, logn: int) -> bool:
        """Whether dispatch sends such a plan to the family."""
        return (self.routes is not None and is64 == (self.word == 64)
                and q < 1 << self.q_bits and self.routes[0] <= logn <= self.routes[1])

    def admit(self, kernel: str, is64: bool, q: int, logn: int) -> None:
        """Raise NTTDispatchError, naming `kernel`, the limits and the
        plan's numbers, unless the kernels take the plan (`admits`)."""
        if not self.admits(is64, q, logn):
            rings = "" if self.takes is None else f" and logn {self.takes[0]}-{self.takes[1]}"
            raise NTTDispatchError(
                f"{kernel} takes u{self.word} plans with q < 2^{self.q_bits}{rings}, got "
                f"is64={is64} q={q} logn={logn}")


def check(kernel: str, shape: tuple, device: torch.device, *xs: torch.Tensor,
          dtypes: tuple = INT64, midx: torch.Tensor | None = None, shift: int = 0) -> None:
    """Refuse operands the kernels do not take: each of `xs` must be a
    contiguous tensor of one of `dtypes`, of shape (batch, *shape), on
    `device`, and all of them of one shape and dtype; `midx`, where
    given, an int32 schedule on `device` of one entry per ring of
    2^shift rows.  Raises NTTDispatchError naming `kernel`, what it
    takes and what it got; NTTDeviceError where `device` is neither the
    CPU nor a card."""
    for x in xs:
        if (x.dtype not in dtypes or x.dim() != len(shape) + 1 or x.shape[1:] != shape
                or not x.is_contiguous() or x.device != device):
            dims = ", ".join(["batch", *map(str, shape)])
            words = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise NTTDispatchError(
                f"{kernel} takes contiguous ({dims}) {words} tensors on {device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    if any(x.shape != xs[0].shape or x.dtype != xs[0].dtype for x in xs):
        raise NTTDispatchError(f"{kernel} takes operands of one shape and dtype, got "
                               f"{[(tuple(x.shape), x.dtype) for x in xs]}")
    if midx is not None and (midx.dtype != torch.int32 or midx.dim() != 1
                             or midx.device != device or midx.numel() << shift != xs[0].shape[0]):
        raise NTTDispatchError(
            f"{kernel} takes an int32 schedule of {xs[0].shape[0] >> shift} entries on "
            f"{device}, got {tuple(midx.shape)} {midx.dtype} on {midx.device}")
    if device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no {kernel} kernel for {device}")


def call(stats: KernelStats, xs: tuple, plain, args: tuple, entry: str, card,
         log_a: int | None = None) -> torch.Tensor:
    """The CPU-or-card choice for operands `xs` that `check` took.  On
    the CPU: plain(*args), one more of stats.plain_calls.  On a card: a
    new output like xs[0] from the C entry `entry` of the library built
    from stats.source, called through `launch` with the operands' and
    the output's pointers, the batch, then card()'s arguments (a
    callable, so that nothing of the card's is built for a CPU call)."""
    x = xs[0]
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return plain(*args)
    y = torch.empty_like(x)
    fn = getattr(library(os.path.basename(stats.source).removesuffix(".cu")), entry)
    launch(stats, fn, x, *(v.data_ptr() for v in xs), y.data_ptr(), x.shape[0], *card(),
           log_a=log_a)
    return y


def launch(stats: KernelStats, fn, x: torch.Tensor, *args, kernel: str | None = None,
           log_a: int | None = None) -> None:
    """Call the C entry `fn` on x's card and current stream, under an
    ntt.launch span whose `kernel` attr is `kernel` or the stats' name and
    whose `word` attr is x's element size in bytes (4 or 8), and, given
    the split's `log_a`, whose `passes` attr is the passes over device
    memory a transform takes (1 for log A 0, else 2); one launch more for
    `stats` once it returns 0."""
    span = tracing.begin(tracing.LAUNCH, "kernel", kernel or stats.name)
    try:
        if span:
            span.attrs["word"] = x.element_size()
            if log_a is not None:
                span.attrs["passes"] = 2 if log_a else 1
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.device.index, *args, ctypes.c_void_p(stream))
        if rc != 0:
            raise NTTDeviceError(f"{stats.name} launch failed: cudaError_t {rc}")
    finally:
        if span:
            span.end()
    stats.launches += 1
