"""Where the device time goes: the merge and 4-step entries under
torch.profiler.

    python -m gpuntt_tpu_torch.utils.launch_profile [iters]

Needs a CUDA card (exits 1 without one).  For each merge cell — u64
2^16 x 128, and the big rings u64 2^20 x 16 and 2^24 x 1 (the 61-bit
pool prime), u32 2^16 x 128 and u32 2^20 x 16 (the pool prime
469762049), all X^N + 1 — it runs `iters` (default 20) calls of
ntt_lanes, intt_lanes and polymul_lanes under torch.profiler, between
two CUDA events, and at u64 2^16 x 128 the same with use_pallas="vpu"
(K15's counterpart), and kmerge_u32 (K17's) at u32 2^16 x 128 in both
directions; at u64 2^27 x 1 (K8's cell: K7 on the columns and the
nested plan's K7 and K8 on its rows of 512; 1 GiB an operand) ntt_lanes
and intt_lanes; for each 4-step cell — u64 and u32 at 2^24 x 1 and
2^16 x 128, X^N - 1, the pool primes of NTTParameters4Step — the same
of fourstep_ntt_lanes and fourstep_intt_lanes; for each RNS cell — u64
2^16 x 64 with a ladder of 8 (K12) and 2^18 x 12 with 3 (K13), X^N - 1,
59-bit primes, and u32 2^16 x 128 and 2^20 x 16 with a ladder of 8 (the
stacked u32 kernels in K16's and K6's ranges), X^N + 1, 30-bit primes,
all on the cyclic schedule — ntt_rns_lanes, intt_rns_lanes and
rns_polymul_lanes (at 2^16 also ntt_rns_lanes routed anew on every
call, its schedule checked and copied to the card, the cost the route
memo saves), and for the RNS
4-step at 2^16 x 64 and 2^20 x 8, ladder 8, rns_fourstep_ntt_lanes and
rns_fourstep_intt_lanes; and for the distributed 4-step at u64 2^24 x 1
on a world of one rank (NCCL, a HashStore), dist_fourstep_ntt and
dist_fourstep_intt (K7' and the rows on K1/K2, the all_to_all, the
torch glue), whose idle share is the host cost of the mesh and
collective layer.  It prints for each entry:

- the window's time per call on the events, and the device's busy and
  idle share of it (the sum of the kernels' device time over the
  window);
- the host time a call of the port's entries (the ntt.entry spans of
  common/tracing.py, recorded under the profiler) spends in the
  entries' own code, in their ntt.route spans and in their ntt.launch
  spans, in milliseconds, from tracing.snapshot() after a
  tracing.reset() before the entry (none for the kernel wrappers and
  the distributed entries, which are no such entry);
- for each kernel launched, the launches per call and the device
  microseconds per launch.

The first line is the card's name and power limit as nvidia-smi gives
them.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..common import tracing

_OURS = ("merge_u", "fourstep", "kmerge")  # the namespaces of csrc/


def _ladder(g, logn: int, count: int, four: bool = False, u32: bool = False):
    """`count` primes of 59 bits, X^N - 1 (or of 30 bits, X^N + 1, for u32)."""
    params = g.NTTParameters4Step if four else g.NTTParameters
    poly = g.ReductionPolynomial.X_N_plus if u32 else g.ReductionPolynomial.X_N_minus
    mod, dtype = (g.Modulus32, np.uint32) if u32 else (g.Modulus64, np.uint64)
    out = []
    for q in g.find_ntt_primes(30 if u32 else 59, logn, count):
        omega, psi = g.ntt_root_pair(q, logn)
        out.append(params(logn, poly, dtype, factors=g.NTTFactors(mod(q), omega, psi)))
    return out


def _short(name: str) -> str:
    """Kernel name without its signature: merge_u32::rows<true>, or
    "torch: <kernel>" for PyTorch's own elementwise kernels."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    name = name.removeprefix("void ")
    if name.startswith(_OURS):
        return name
    return "torch: " + name.split("<")[0].split("::")[-1]


def profile(fn, iters: int) -> None:
    fn()
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    rows: dict[str, list[float]] = {}
    for e in prof.key_averages():
        # the profiler lays the ntt.* spans on the device's timeline too
        # (the kernels they launched): they are no device work of their own
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("ntt."):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            row = rows.setdefault(_short(e.key), [0, 0.0])
            row[0] += e.count
            row[1] += t
    busy = sum(t for _, t in rows.values())
    print(f"  {window_us / iters:.3f} us per call on events; device busy "
          f"{busy / window_us:.1%}, idle {1 - busy / window_us:.1%}")
    split = tracing.split_ms(tracing.snapshot()["spans"])
    if split["calls"]:
        print(f"  host ms per call: entry self {split['entry_self']:.4f}, route "
              f"{split['route']:.4f}, launch {split['launch']:.4f} ({split['calls']} calls)")
    for name, (count, t) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        print(f"    {name}: {count / iters:g} per call, {t / count:.3f} us per launch")


def main(iters: int = 20) -> int:
    if not torch.cuda.is_available():
        print("launch_profile: no CUDA device visible to torch", file=sys.stderr)
        return 1
    import gpuntt_tpu_torch as g

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for dtype, logn, batch in ((np.uint64, 16, 128), (np.uint64, 20, 16), (np.uint64, 24, 1),
                               (np.uint32, 16, 128), (np.uint32, 20, 16)):
        p = g.NTTParameters(logn, g.ReductionPolynomial.X_N_plus, dtype)
        plan = g.MergePlan.from_params(p, device=dev)
        a, b = (torch.from_numpy(rng.integers(0, p.modulus.value, size=(batch, p.n),
                                              dtype=np.int64)).to(dev)
                for _ in range(2))
        fa = g.ntt_lanes(a, plan)
        bits = 64 if dtype == np.uint64 else 32
        for entry, fn in (("ntt_lanes", lambda: g.ntt_lanes(a, plan)),
                          ("intt_lanes", lambda: g.intt_lanes(fa, plan)),
                          ("polymul_lanes", lambda: g.polymul_lanes(a, b, plan))):
            print(f"u{bits} 2^{logn}x{batch} {entry}:")
            profile(fn, iters)
        if (logn, batch) != (16, 128):
            continue
        if dtype == np.uint64:
            for entry, fn in (
                    ("ntt_lanes", lambda: g.ntt_lanes(a, plan, use_pallas="vpu")),
                    ("intt_lanes", lambda: g.intt_lanes(fa, plan, use_pallas="vpu")),
                    ("polymul_lanes", lambda: g.polymul_lanes(a, b, plan, use_pallas="vpu"))):
                print(f"u64 2^16x128 {entry} use_pallas=vpu (K15):")
                profile(fn, iters)
            continue
        from gpuntt_tpu_torch.ops import hopper_kmerge as hk

        kp = hk.kernel_plan(plan)
        for inverse in (False, True):
            print(f"u32 2^16x128 kmerge_u32 inverse={inverse} (K17):")
            profile(lambda: hk.kmerge_u32(a, kp, inverse=inverse), iters)
    # K8's cell: the 2^27 ring's nested rows of 512 (1 GiB an operand; no polymul)
    p = g.NTTParameters(27, g.ReductionPolynomial.X_N_plus, np.uint64)
    plan = g.MergePlan.from_params(p, device=dev)
    a = torch.from_numpy(rng.integers(0, p.modulus.value, size=(1, p.n),
                                      dtype=np.int64)).to(dev)
    fa = g.ntt_lanes(a, plan)
    for entry, fn in (("ntt_lanes", lambda: g.ntt_lanes(a, plan)),
                      ("intt_lanes", lambda: g.intt_lanes(fa, plan))):
        print(f"u64 2^27x1 {entry}:")
        profile(fn, iters)
    del a, fa, plan
    for dtype, logn, batch in ((np.uint64, 24, 1), (np.uint64, 16, 128), (np.uint32, 24, 1),
                               (np.uint32, 16, 128)):
        p = g.NTTParameters4Step(logn, g.ReductionPolynomial.X_N_minus, dtype)
        plan = g.FourStepPlan.from_params(p, device=dev)
        a = torch.from_numpy(rng.integers(0, p.modulus.value, size=(batch, p.n),
                                          dtype=np.int64)).to(dev)
        bits = 64 if dtype == np.uint64 else 32
        for entry, fn in (("fourstep_ntt_lanes", lambda: g.fourstep_ntt_lanes(a, plan)),
                          ("fourstep_intt_lanes", lambda: g.fourstep_intt_lanes(a, plan))):
            print(f"4-step u{bits} 2^{logn}x{batch} {entry}:")
            profile(fn, iters)
    from gpuntt_tpu_torch.ops import dispatch as td

    for u32, logn, batch, count in ((False, 16, 64, 8), (False, 18, 12, 3), (True, 16, 128, 8),
                                    (True, 20, 16, 8)):
        plan = g.RNSMergePlan.from_params(_ladder(g, logn, count, u32=u32), device=dev)
        mod_idx = np.arange(batch) % count
        a, b = (torch.from_numpy(rng.integers(0, min(plan.qs), size=(batch, plan.n),
                                              dtype=np.int64)).to(dev) for _ in range(2))
        fa = td.ntt_rns_lanes(a, plan, mod_idx)
        entries = [("ntt_rns_lanes", lambda: td.ntt_rns_lanes(a, plan, mod_idx)),
                   ("intt_rns_lanes", lambda: td.intt_rns_lanes(fa, plan, mod_idx)),
                   ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(a, b, plan, mod_idx))]
        if (u32, logn) == (False, 16):  # what the route memo saves: the route every call
            entries.append(("ntt_rns_lanes, routed anew every call",
                            lambda: (plan._lazy.pop("routes", None),
                                     td.ntt_rns_lanes(a, plan, mod_idx))))
        for entry, fn in entries:
            print(f"RNS u{32 if u32 else 64} 2^{logn}x{batch} ladder {count} {entry}:")
            profile(fn, iters)
    for logn, batch in ((16, 64), (20, 8)):
        plan = g.RNSFourStepPlan.from_params(_ladder(g, logn, 8, four=True), device=dev)
        mod_idx = np.arange(batch) % 8
        a = torch.from_numpy(rng.integers(0, min(plan.qs), size=(batch, plan.n),
                                          dtype=np.int64)).to(dev)
        for entry, fn in (("rns_fourstep_ntt_lanes",
                           lambda: g.rns_fourstep_ntt_lanes(a, plan, mod_idx)),
                          ("rns_fourstep_intt_lanes",
                           lambda: g.rns_fourstep_intt_lanes(a, plan, mod_idx))):
            print(f"RNS 4-step u64 2^{logn}x{batch} ladder 8 {entry}:")
            profile(fn, iters)
    import torch.distributed as dist

    from gpuntt_tpu_torch.parallel import mesh as M
    from gpuntt_tpu_torch.parallel.fourstep_dist import (DistFourStepPlan, dist_fourstep_intt,
                                                         dist_fourstep_ntt)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh = M.make_mesh(1, 1, device=dev)
    p = g.NTTParameters4Step(24, g.ReductionPolynomial.X_N_minus, np.uint64)
    dplan = DistFourStepPlan.from_params(p, device=dev)
    x = torch.from_numpy(rng.integers(0, p.modulus.value, size=(1, p.n1, p.n2),
                                      dtype=np.int64)).to(dev)
    spec = dist_fourstep_ntt(x, dplan, mesh)
    for entry, fn in (("dist_fourstep_ntt", lambda: dist_fourstep_ntt(x, dplan, mesh)),
                      ("dist_fourstep_intt", lambda: dist_fourstep_intt(spec, dplan, mesh))):
        print(f"dist 4-step u64 2^24x1 world size 1 {entry}:")
        profile(fn, iters)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(v) for v in sys.argv[1:])))
