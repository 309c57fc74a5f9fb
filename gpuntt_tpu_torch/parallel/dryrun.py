"""Multi-rank dry run of the three distribution strategies.

The port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: one full distributed step of each
strategy on n ranks, each checked against the golden models.

    python -m gpuntt_tpu_torch.parallel.dryrun [n_ranks] [cpu] [reduced]

`dryrun_multichip(n_ranks, device=None)` starts n ranks with the spawn
method (so a rank imports torch and this package, nothing else) over a
FileStore in a temporary directory (no network): NCCL on n cards by
default, gloo on the host with device="cpu".  Every rank runs the seven
scenarios of the JAX round's dry run, and rank 0 prints one
`dryrun_multichip OK [...]` line for each:

1. 4-step all_to_all: DistPolynomialMultiplier on a dp x sp mesh (dp = 2
   when n is even), ring 2^16, batch 2 dp, pipeline_chunks 2;
2. merge collective_permute: dist_merge_ntt / dist_merge_intt on a
   1 x n mesh, ring 2^17, X^N + 1, batch 2;
3. RNS 4-step all_to_all: DistRNSPolynomialMultiplier, ring 2^16, a
   ladder of two 59-bit primes;
4. merge north-star: ring 2^20 on 1 x n, whose tails of 2^20 / n words
   run the big-ring composition from 2^18 (n <= 4) and K1/K2 below;
5. RNS 4-step north-star: ring 2^20, a ladder of 4;
6-7. 4-step north-star: dist_fourstep_ntt / _intt at 2^20 and 2^24,
   batch 1, n2 over all n ranks.

`reduced=True` runs every ring at 2^12-2^14 instead (the CPU tests).
A failed check raises in its rank, and dryrun_multichip raises.

    python -m gpuntt_tpu_torch.parallel.dryrun bytes

prints `collective_bytes` of each strategy at rings 2^20 and 2^24 over
sp = 2, 4 and 8: what one transform makes a rank send, counted from the
shapes, not timed (the CPU tests hold the count against the bytes the
collectives are handed).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..common.errors import NTTDeviceError

_FULL = dict(step=16, merge=17, rns=16, merge_big=20, rns_big=20, big=(20, 24))
_REDUCED = dict(step=13, merge=12, rns=12, merge_big=14, rns_big=13, big=(13, 14))


def collective_bytes(strategy: str, logn: int, sp: int, batch: int = 1, dp: int = 1) -> int:
    """Bytes one rank sends to the others in one transform of a (batch, 2^logn)
    int64 lane batch on a dp x sp mesh: the 4-step ("fourstep", and the RNS
    4-step alike) sends (sp - 1) / sp of its block in its all_to_all; the
    merge ("merge") its whole shard at each of log2(sp) cross stages."""
    block = 8 * (batch // dp) * ((1 << logn) // sp)
    if strategy == "fourstep":
        return block * (sp - 1) // sp
    if strategy == "merge":
        return block * (sp.bit_length() - 1)
    raise ValueError(f"unknown strategy {strategy!r}")


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _scenarios(n: int, device: torch.device, rings: dict, say) -> None:
    import gpuntt_tpu_torch as g
    from ..models.polymul import DistPolynomialMultiplier, DistRNSPolynomialMultiplier
    from . import mesh as M
    from .fourstep_dist import DistFourStepPlan, dist_fourstep_intt, dist_fourstep_ntt
    from .merge_dist import dist_merge_intt, dist_merge_ntt

    MINUS, PLUS = g.ReductionPolynomial.X_N_minus, g.ReductionPolynomial.X_N_plus
    rng = np.random.default_rng(0)
    dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    mesh = M.make_mesh(dp, sp, device=device)
    line = M.make_mesh(1, n, device=device)

    def lanes(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)

    def blocks(a: np.ndarray, p, m=mesh) -> torch.Tensor:
        return M.shard(lanes(a).view(a.shape[0], p.n1, p.n2), m, M.BLOCKS)

    def golden_step(p, a, b):
        gen = g.NTT4StepCPU(p)
        return gen.intt(gen.mult(gen.ntt(a), gen.ntt(b)))

    # 1. the 4-step polymul, pipelined
    p = g.NTTParameters4Step(rings["step"], MINUS, np.uint64)
    batch = 2 * dp
    a, b = (rng.integers(0, p.modulus.value, (batch, p.n), dtype=np.uint64) for _ in range(2))
    model = DistPolynomialMultiplier(p, mesh, pipeline_chunks=2, device=device)
    out = _u64(M.unshard(model.step_lanes(blocks(a, p), blocks(b, p)), mesh, M.BLOCKS))
    assert np.array_equal(out.reshape(batch, p.n)[0], golden_step(p, a[0], b[0])), \
        "multi-rank step diverged from golden"
    say(f"[4-step all_to_all]: mesh {dp}x{sp}, ring 2^{p.logn} (n2 {p.n2} sharded over "
        f"sp), batch {batch}, pipeline_chunks 2, bit-exact vs golden")

    def merge(key, what):  # 2. and 4.: the merge, coefficient-sharded over every rank
        pm = g.NTTParameters(rings[key], PLUS, np.uint64)
        plan = g.MergePlan.from_params(pm, device=device)
        rows = 2 if key == "merge" else 1
        x = rng.integers(0, pm.modulus.value, (rows, pm.n), dtype=np.uint64)
        xl = M.shard(lanes(x), line, M.ROWS)
        spec = dist_merge_ntt(xl, plan, line)
        gen = g.NTTCPU(pm)
        got = _u64(M.unshard(spec, line, M.ROWS))
        assert np.array_equal(got, np.stack([gen.ntt(v) for v in x])), f"{what} NTT diverged"
        assert torch.equal(dist_merge_intt(spec, plan, line), xl), f"{what} round trip"
        tail = pm.logn - (n.bit_length() - 1)
        say(f"{what}: mesh 1x{n}, ring 2^{pm.logn}, local tails of 2^{tail} (from_eval"
            f"{', big-ring plan' if tail >= 18 else ''}), batch {rows}, bit-exact vs golden")

    def rns(key, count, what):  # 3. and 5.: the RNS 4-step polymul
        logn = rings[key]
        members = []
        for q in g.find_ntt_primes(59, logn, count):
            omega, psi = g.ntt_root_pair(q, logn)
            members.append(g.NTTParameters4Step(logn, MINUS, np.uint64,
                                                factors=g.NTTFactors(g.Modulus64(q), omega, psi)))
        rmodel = DistRNSPolynomialMultiplier(members, mesh, device=device)
        mod_idx = np.arange(batch) % count
        ar, br = (np.stack([rng.integers(0, members[m].modulus.value, members[0].n,
                                         dtype=np.uint64) for m in mod_idx]) for _ in range(2))
        outr = rmodel.step_lanes(blocks(ar, members[0]), blocks(br, members[0]), mod_idx)
        gotr = _u64(M.unshard(outr, mesh, M.BLOCKS)).reshape(batch, -1)
        assert np.array_equal(gotr[0], golden_step(members[0], ar[0], br[0])), \
            f"{what} step diverged from golden"
        say(f"{what}: mesh {dp}x{sp}, ring 2^{logn}, ladder of {count}, batch {batch}, "
            f"bit-exact vs golden")

    merge("merge", "[merge collective_permute]")
    rns("rns", 2, "[RNS 4-step all_to_all]")
    merge("merge_big", "[merge north-star]")
    rns("rns_big", 4, "[RNS 4-step north-star]")

    # 6. and 7. the 4-step at the north-star rings, n2 over every rank
    for logn in rings["big"]:
        pn = g.NTTParameters4Step(logn, MINUS, np.uint64)
        dplan = DistFourStepPlan.from_params(pn, device=device)
        x = rng.integers(0, pn.modulus.value, (1, pn.n), dtype=np.uint64)
        xl = blocks(x, pn, line)
        spec = dist_fourstep_ntt(xl, dplan, line)
        got = _u64(M.unshard(spec, line, M.BLOCKS)).reshape(1, pn.n)
        assert np.array_equal(got[0], g.NTT4StepCPU(pn).ntt(x[0])), \
            f"dist 4-step 2^{logn} diverged from golden"
        assert torch.equal(dist_fourstep_intt(spec, dplan, line), xl), \
            f"dist 4-step 2^{logn} inverse round trip diverged"
        say(f"[4-step north-star]: mesh 1x{n}, ring 2^{logn} (n1xn2={pn.n1}x{pn.n2}, n2 "
            f"sharded over sp), batch 1, fwd bit-exact vs golden + inverse round-trip")


def _rank(rank: int, n: int, store: str, device_type: str, worker, args) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        worker(rank, n, device, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(worker, n_ranks: int, device=None, *args) -> None:
    """worker(rank, n_ranks, device, *args) in n_ranks processes started
    with the spawn method, each a rank of a default group over a FileStore
    in a temporary directory (no network): NCCL on the first n_ranks cards
    by default (NTTDeviceError without them), gloo with device="cpu".
    `worker` is a module-level function; a rank that raises makes this
    raise."""
    device_type = torch.device(device).type if device is not None else "cuda"
    if device_type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise NTTDeviceError(f"{n_ranks} ranks need {n_ranks} CUDA cards, found "
                             f"{torch.cuda.device_count()}; device='cpu' runs gloo ranks")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(n_ranks, os.path.join(d, "store"), device_type,
                                        worker, args), nprocs=n_ranks, start_method="spawn")


def _dryrun(rank: int, n: int, device: torch.device, reduced: bool) -> None:
    _scenarios(n, device, _REDUCED if reduced else _FULL,
               lambda s: rank == 0 and print(f"dryrun_multichip OK {s}", flush=True))


def dryrun_multichip(n_ranks: int, device=None, reduced: bool = False) -> None:
    """Run the seven scenarios on n_ranks ranks (see the module note):
    NCCL on n_ranks cards by default (NTTDeviceError without them), gloo
    on the host with device="cpu"."""
    if n_ranks & (n_ranks - 1) or n_ranks < 1:
        raise ValueError(f"n_ranks must be a power of two, got {n_ranks}")
    run_ranks(_dryrun, n_ranks, device, reduced)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["bytes"]:
        for logn in (20, 24):
            for sp in (2, 4, 8):
                print(f"ring 2^{logn} batch 1 over sp {sp}: bytes a rank sends per transform: "
                      f"4-step (and RNS 4-step, per row) "
                      f"{collective_bytes('fourstep', logn, sp)}, merge "
                      f"{collective_bytes('merge', logn, sp)}")
        sys.exit(0)
    dryrun_multichip(int(args[0]) if args else 1, "cpu" if "cpu" in args else None,
                     "reduced" in args)
