"""Multi-rank polynomial multiplication over the sharded 4-step NTT.

No reference counterpart: GPU-NTT is single-device (SURVEY.md §2,
"parallelism strategies").  The N = n1 x n2 decomposition shards the n2
axis over mesh axis "sp" (column NTTs local, one all_to_all as the
distributed transpose, row NTTs local) while the batch rides "dp", with
dp = 2 when the world size is even — and the result stays bit-exact vs
the single-device golden model.

    python -m gpuntt_tpu_torch.examples.example_distributed_polymul [LOG2_RING] [BATCH] [--device=cuda|cpu]

With --device=cpu it starts 4 gloo ranks (parallel/dryrun.run_ranks),
the counterpart of the JAX script's 4 virtual CPU devices.  On the card
it runs in this process at world size 1 on NCCL (a HashStore, no
network; NCCL refuses two ranks on one card), or over the default
process group if one exists; the u64 column phase then runs K7'
(csrc/merge_u64_large.cu merge_u64_large_col*_local).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import NTT4StepCPU, NTTParameters4Step, ReductionPolynomial, check_result
from ..models.polymul import DistPolynomialMultiplier
from ..parallel import mesh as M
from ..parallel.dryrun import run_ranks
from . import _device

CPU_RANKS = 4


def params(logn: int) -> NTTParameters4Step:
    return NTTParameters4Step(logn, ReductionPolynomial.X_N_minus, dtype=np.uint64)


def operands(logn: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    p = params(logn)
    rng = np.random.default_rng(0)
    a = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    b = rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)
    return a, b


def step(rank: int, n: int, device: torch.device, logn: int, batch: int,
         out: str | None = None) -> np.ndarray:
    """This rank's part of one DistPolynomialMultiplier step on a dp x sp
    mesh of the default group's n ranks; the gathered product (every
    rank), saved to `out` by rank 0 when given."""
    dp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = M.make_mesh(dp=dp, sp=n // dp, device=device)
    if rank == 0:
        print(f"mesh: dp={dp} x sp={n // dp} on {device.type}", flush=True)
    p = params(logn)
    model = DistPolynomialMultiplier(p, mesh, device=device)
    a, b = operands(logn, batch)

    def put(x: np.ndarray) -> torch.Tensor:
        lanes = torch.from_numpy(x.view(np.int64)).to(device)
        return M.shard(lanes.view(batch, p.n1, p.n2), mesh, M.BLOCKS)

    got = M.unshard(model.step_lanes(put(a), put(b)), mesh, M.BLOCKS)
    got = got.cpu().numpy().view(np.uint64).reshape(batch, p.n)
    if rank == 0 and out is not None:
        np.save(out, got)
    return got


def compute(logn: int, batch: int, device) -> dict[str, np.ndarray]:
    """The operands and the gathered product."""
    device = torch.device(device)
    a, b = operands(logn, batch)
    if device.type == "cpu":
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "product.npy")
            run_ranks(step, CPU_RANKS, "cpu", logn, batch, path)
            product = np.load(path)
    elif dist.is_initialized():
        product = step(dist.get_rank(), dist.get_world_size(), device, logn, batch)
    else:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            product = step(0, 1, device, logn, batch)
        finally:
            dist.destroy_process_group()
    return dict(a=a, b=b, product=product)


def main(argv=None) -> int:
    logn, batch, device = _device.parse(sys.argv[1:] if argv is None else argv, 12, 4)
    out = compute(logn, batch, device)
    gen = NTT4StepCPU(params(logn))
    exp = np.stack([gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))
                    for a, b in zip(out["a"], out["b"])])
    ok = check_result(out["product"], exp)
    print("All Correct." if ok else "Error!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
