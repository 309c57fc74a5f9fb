"""Entry points of the port: the counterpart of __graft_entry__.py.

`entry(device=None)` returns `(fn, args)`: the flagship step, batched
negacyclic polynomial multiplication over the merged NTT with the 64-bit
pool modulus (`PolynomialMultiplier.step_lanes`, u64 2^12 x 4, X^N + 1),
and its operands drawn from default_rng(0) as int64 lanes on `device`
(the first card by default).  On the card the step is K1 twice and the
fused inverse K3 (csrc/merge_u64.cu).

    python -m gpuntt_tpu_torch.entry [n_ranks] [reduced] [--device=cpu]

(a) checks the step.  On the card this is the counterpart of the JAX
    package's compile check, a CUDA-graph capture (`graph_check`): one
    eager call (plans, tables and the kernels' builds happen then), one
    call captured in a torch.cuda.CUDAGraph on a side stream, and a
    replay; the replay must equal the eager output and NTTCPU's
    intt(mult(ntt(a), ntt(b))).  With --device=cpu (CUDA graphs need a
    card) the eager call alone is held to NTTCPU.
(b) runs `parallel.dryrun.dryrun_multichip(n_ranks, device="cpu",
    reduced=...)` on gloo ranks, 8 by default as in the JAX package.

It exits 0 when both pass.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .models.polymul import PolynomialMultiplier
from .ops.limb import from_numpy_u64, to_numpy_u64
from .params.merge import NTTParameters, ReductionPolynomial
from .reference.merge_cpu import NTTCPU

LOGN, BATCH = 12, 4


def params() -> NTTParameters:
    return NTTParameters(LOGN, ReductionPolynomial.X_N_plus, dtype=np.uint64)


def operands() -> tuple[np.ndarray, np.ndarray]:
    """The step's operands as __graft_entry__.entry draws them."""
    p = params()
    rng = np.random.default_rng(0)
    a = rng.integers(0, p.modulus.value, size=(BATCH, p.n), dtype=np.uint64)
    b = rng.integers(0, p.modulus.value, size=(BATCH, p.n), dtype=np.uint64)
    return a, b


def entry(device=None):
    """(fn, example_args): the flagship model's forward step and its
    operands as int64 lanes on `device`."""
    model = PolynomialMultiplier(params(), device=device)
    dev = model.plan.device
    a, b = operands()
    return model.step_lanes, (from_numpy_u64(a, dev), from_numpy_u64(b, dev))


def golden() -> np.ndarray:
    """NTTCPU's intt(mult(ntt(a), ntt(b))) of the step's operands."""
    gen = NTTCPU(params())
    a, b = operands()
    return gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))


def graph_check(fn, args) -> tuple[torch.Tensor, torch.Tensor, torch.cuda.CUDAGraph]:
    """(eager output, replayed output, the graph) of fn(*args) on the
    card: an eager call, a warm-up on a side stream, one call captured in
    a CUDA graph and a replay.  A host synchronisation or an allocation
    that capture forbids raises here."""
    eager = fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    return eager, static_out, graph


def main(argv=None) -> int:
    from .examples._device import resolve, split
    from .parallel.dryrun import dryrun_multichip

    rest, name = split(sys.argv[1:] if argv is None else argv)
    n_ranks = int(rest[0]) if rest and rest[0].isdigit() else 8
    device = resolve(name)
    fn, args = entry(device)
    want = golden()
    if device.type == "cuda":
        eager, replay, _ = graph_check(fn, args)
        ok = torch.equal(replay, eager) and np.array_equal(to_numpy_u64(replay), want)
        print(f"entry() CUDA-graph check (replay == eager == NTTCPU): {ok}")
    else:
        ok = np.array_equal(to_numpy_u64(fn(*args)), want)
        print(f"entry() eager check on {device} (== NTTCPU; a CUDA graph needs a card): {ok}")
    if not ok:
        return 1
    dryrun_multichip(n_ranks, device="cpu", reduced="reduced" in rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
