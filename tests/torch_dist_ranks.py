"""Rank workers of the distributed CPU tests (test_torch_dist.py,
test_torch_merge_dist.py).

Each worker runs in a gloo rank started by
gpuntt_tpu_torch.parallel.dryrun.run_ranks (spawn), so this module
imports torch, numpy and the port only.  A worker runs every cell of its
file once, checks what needs no reference (the round trip, the
pipelined and engine routes against the default one) in the rank, and
rank 0 saves each gathered global result as <outdir>/<cell>.npy for the
test process to hold against the JAX package.  Inputs come from numpy
seeds that the tests repeat (`inputs`).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.models.polymul import DistPolynomialMultiplier, DistRNSPolynomialMultiplier
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.parallel import mesh as M
from gpuntt_tpu_torch.parallel.fourstep_dist import (DistFourStepPlan, _colmat_ok,
                                                     dist_fourstep_intt, dist_fourstep_ntt)
from gpuntt_tpu_torch.parallel.fourstep_rns_dist import (DistRNSFourStepPlan,
                                                         dist_rns_fourstep_intt,
                                                         dist_rns_fourstep_ntt)
from gpuntt_tpu_torch.parallel.merge_dist import dist_merge_intt, dist_merge_ntt

MINUS = tg.ReductionPolynomial.X_N_minus
PLUS = tg.ReductionPolynomial.X_N_plus
DTYPES = {"u64": np.uint64, "u32": np.uint32}
BATCH = 4

# (dtype, dp, sp, logn) of the dist 4-step; the colmat cells at 2^13 and 2^16
FOURSTEP = [(d, dp, sp, logn) for d in DTYPES for dp, sp in ((1, 2), (2, 2))
            for logn in (12, 13, 14)]
COLMAT = [("u64", 2, 2, 13), ("u64", 1, 4, 13), ("u64", 2, 2, 16), ("u64", 1, 4, 16)]
# (dtype, poly, dp, sp, logn) of the dist merge
MERGE = [(d, poly, dp, sp, logn) for d in DTYPES for poly in ("minus", "plus")
         for dp, sp in ((2, 2), (1, 4)) for logn in (12, 13)]
RNS = [("u64", 3), ("u64", 2), ("u32", 3)]  # (dtype, ladder) at 2^12 on 2 x 2
MODELS = [("u64", 1), ("u64", 2), ("u32", 1)]  # (dtype, pipeline_chunks) at 2^13 on 2 x 2


def name(*cell) -> str:
    return "_".join(str(c) for c in cell)


def members(dtype: str, count: int, logn: int = 12):
    """The RNS cells' ladder: 59-bit (u64) or 30-bit (u32) primes."""
    mod = tg.Modulus64 if dtype == "u64" else tg.Modulus32
    out = []
    for q in tg.find_ntt_primes(59 if dtype == "u64" else 30, logn, count):
        f = tg.NTTFactors(mod(q), *tg.ntt_root_pair(q, logn))
        out.append(tg.NTTParameters4Step(logn, MINUS, DTYPES[dtype], factors=f))
    return out


def inputs(seed: int, qs, shape) -> np.ndarray:
    """Canonical residues, row b below qs[b % len(qs)], as uint64."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, qs[b % len(qs)], shape[1:], dtype=np.uint64)
                     for b in range(shape[0])])


def _lanes(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _save(outdir: str, key: str, t: torch.Tensor, rank: int) -> None:
    if rank == 0:
        np.save(os.path.join(outdir, key + ".npy"), t.numpy().view(np.uint64))


def _sent_bytes(fn) -> int:
    """Bytes this rank hands the collectives for other ranks during fn():
    every all_to_all_single chunk but its own, every isend."""
    sent = [0]
    a2a, p2p = dist.all_to_all_single, dist.batch_isend_irecv

    def all_to_all_single(out, inp, group=None, async_op=False):
        sent[0] += inp.numel() * 8 * (dist.get_world_size(group) - 1) // dist.get_world_size(group)
        return a2a(out, inp, group=group, async_op=async_op)

    def batch_isend_irecv(ops):
        sent[0] += sum(op.tensor.numel() * 8 for op in ops if op.op is dist.isend)
        return p2p(ops)

    dist.all_to_all_single, dist.batch_isend_irecv = all_to_all_single, batch_isend_irecv
    try:
        fn()
    finally:
        dist.all_to_all_single, dist.batch_isend_irecv = a2a, p2p
    return sent[0]


def _save_bytes(outdir: str, key: str, fn, rank: int) -> None:
    np.save(os.path.join(outdir, f"{key}_rank{rank}.npy"), np.array(_sent_bytes(fn)))


def fourstep_worker(rank: int, n: int, device, outdir: str) -> None:
    """The dist 4-step, the colmat route, the RNS 4-step and the models."""
    meshes = {(dp, sp): M.make_mesh(dp, sp, device="cpu") for dp, sp in ((1, 2), (2, 2), (1, 4))}
    for cell in FOURSTEP + COLMAT:
        dtype, dp, sp, logn = cell
        if rank >= dp * sp:
            continue
        mesh = meshes[(dp, sp)]
        p = tg.NTTParameters4Step(logn, MINUS, DTYPES[dtype])
        dplan = DistFourStepPlan.from_params(p, device="cpu")
        x = M.shard(_lanes(inputs(logn, [p.modulus.value], (BATCH, p.n1, p.n2))), mesh, M.BLOCKS)
        s = M.shard(_lanes(inputs(logn + 1, [p.modulus.value], (BATCH, p.n2, p.n1))), mesh,
                    M.BLOCKS)
        hml.reset_counts()
        fwd = dist_fourstep_ntt(x, dplan, mesh)
        inv = dist_fourstep_intt(s, dplan, mesh)
        k7 = hml.COLFWD_LOCAL.plain_calls + hml.COLINV_LOCAL.plain_calls
        assert k7 == (2 if _colmat_ok(dplan, sp, None) else 0), (cell, k7)
        assert torch.equal(dist_fourstep_intt(fwd, dplan, mesh), x), cell
        for kw in (dict(pipeline_chunks=2), dict(local_engine="xla")):
            assert torch.equal(dist_fourstep_ntt(x, dplan, mesh, **kw), fwd), (cell, kw)
            assert torch.equal(dist_fourstep_intt(s, dplan, mesh, **kw), inv), (cell, kw)
        _save(outdir, name("fwd", *cell), M.unshard(fwd, mesh, M.BLOCKS), rank)
        _save(outdir, name("inv", *cell), M.unshard(inv, mesh, M.BLOCKS), rank)
        if cell == ("u64", 2, 2, 13):
            _save_bytes(outdir, "bytes_fourstep", lambda: dist_fourstep_ntt(x, dplan, mesh), rank)

    mesh = meshes[(2, 2)]
    for dtype, count in RNS:
        ms = members(dtype, count)
        p0, qs = ms[0], [m.modulus.value for m in ms]
        mod_idx = np.arange(BATCH) % count
        dplan = DistRNSFourStepPlan.from_members(ms, device="cpu")
        x = M.shard(_lanes(inputs(count, qs, (BATCH, p0.n1, p0.n2))), mesh, M.BLOCKS)
        y = M.shard(_lanes(inputs(count + 1, qs, (BATCH, p0.n1, p0.n2))), mesh, M.BLOCKS)
        s = M.shard(_lanes(inputs(count + 2, qs, (BATCH, p0.n2, p0.n1))), mesh, M.BLOCKS)
        fwd = dist_rns_fourstep_ntt(x, dplan, mesh, mod_idx)
        inv = dist_rns_fourstep_intt(s, dplan, mesh, mod_idx)
        assert torch.equal(dist_rns_fourstep_intt(fwd, dplan, mesh, mod_idx), x)
        assert torch.equal(dist_rns_fourstep_ntt(x, dplan, mesh, mod_idx, local_engine="xla"),
                           fwd)
        prod = DistRNSPolynomialMultiplier(ms, mesh).step_lanes(x, y, mod_idx)
        for key, t in (("fwd", fwd), ("inv", inv), ("prod", prod)):
            _save(outdir, name("rns", key, dtype, count), M.unshard(t, mesh, M.BLOCKS), rank)

    for dtype, chunks in MODELS:
        p = tg.NTTParameters4Step(13, MINUS, DTYPES[dtype])
        x = M.shard(_lanes(inputs(5, [p.modulus.value], (BATCH, p.n1, p.n2))), mesh, M.BLOCKS)
        y = M.shard(_lanes(inputs(6, [p.modulus.value], (BATCH, p.n1, p.n2))), mesh, M.BLOCKS)
        prod = DistPolynomialMultiplier(p, mesh, pipeline_chunks=chunks).step_lanes(x, y)
        _save(outdir, name("model", dtype, chunks), M.unshard(prod, mesh, M.BLOCKS), rank)


def merge_worker(rank: int, n: int, device, outdir: str) -> None:
    """The dist merge: forward, inverse with and without n^-1, on the
    kernels' plain versions and on the engine."""
    meshes = {(dp, sp): M.make_mesh(dp, sp, device="cpu") for dp, sp in ((2, 2), (1, 4))}
    for cell in MERGE:
        dtype, poly, dp, sp, logn = cell
        mesh = meshes[(dp, sp)]
        p = tg.NTTParameters(logn, MINUS if poly == "minus" else PLUS, DTYPES[dtype])
        plan = tg.MergePlan.from_params(p, device="cpu")
        x = M.shard(_lanes(inputs(logn, [p.modulus.value], (BATCH, p.n))), mesh, M.ROWS)
        s = M.shard(_lanes(inputs(logn + 1, [p.modulus.value], (BATCH, p.n))), mesh, M.ROWS)
        fwd = dist_merge_ntt(x, plan, mesh)
        inv = dist_merge_intt(s, plan, mesh)
        raw = dist_merge_intt(s, plan, mesh, scale=False)
        assert torch.equal(dist_merge_intt(fwd, plan, mesh), x), cell
        assert torch.equal(dist_merge_ntt(x, plan, mesh, local_engine="xla"), fwd), cell
        assert torch.equal(dist_merge_intt(s, plan, mesh, local_engine="xla"), inv), cell
        for key, t in (("fwd", fwd), ("inv", inv), ("raw", raw)):
            _save(outdir, name(key, *cell), M.unshard(t, mesh, M.ROWS), rank)
        if cell == ("u64", "plus", 1, 4, 13):
            _save_bytes(outdir, "bytes_merge", lambda: dist_merge_ntt(x, plan, mesh), rank)
