"""The port's distributed 4-step, RNS 4-step and Dist models, held
bit-exact against the JAX package on gloo ranks.

One spawn of 4 gloo ranks (`ranks`, module scope) runs every cell of
tests/torch_dist_ranks.fourstep_worker: the dist 4-step at u64 and u32,
(dp, sp) = (1, 2) and (2, 2), rings 2^12-2^14, batch 4; the colmat route
(K7''s plain version) at 2^13 and 2^16 with sp = 2 and 4, where
n2 / sp = 64 leaves it for the engine route; the RNS 4-step on ladders
of 2 and 3 (u64) and 3 (u32) at 2^12 on 2 x 2; both Dist models.  The
ranks check the round trip, pipeline_chunks=2 and local_engine="xla"
against the default route themselves; the tests hold every gathered
result against the JAX package's golden models (gpuntt_tpu.NTT4StepCPU,
to which its own distributed tests hold its dist functions:
tests/test_distributed.py, tests/test_rns_dist.py).  The JAX dist
functions themselves take minutes of XLA compiles a cell on the CPU, so
the cells against them are marked slow.  Also here: world size 1 in this
process against the single-chip entries, the dry run on 4 ranks, the
plan converters, the X^N + 1 refusals, the mesh's refusals.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gpuntt_tpu as jg
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.models.polymul import DistPolynomialMultiplier, DistRNSPolynomialMultiplier
from gpuntt_tpu_torch.ops import fourstep as tf
from gpuntt_tpu_torch.parallel import mesh as M
from gpuntt_tpu_torch.parallel.dryrun import collective_bytes, dryrun_multichip, run_ranks
from gpuntt_tpu_torch.parallel.fourstep_dist import (DistFourStepPlan, dist_fourstep_intt,
                                                     dist_fourstep_ntt)
from gpuntt_tpu_torch.parallel.fourstep_rns_dist import (DistRNSFourStepPlan,
                                                         dist_rns_fourstep_intt,
                                                         dist_rns_fourstep_ntt)
from gpuntt_tpu_torch.parallel.merge_dist import dist_merge_intt, dist_merge_ntt

import torch_dist_ranks as R

JMINUS = jg.ReductionPolynomial.X_N_minus


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_fourstep"))
    run_ranks(R.fourstep_worker, 4, "cpu", out)
    return lambda key: np.load(os.path.join(out, key + ".npy"))


def jparams(logn, dtype, q=None):
    """The JAX package's 4-step parameters (its pool prime, or q)."""
    if q is None:
        return jg.NTTParameters4Step(logn, JMINUS, dtype=dtype)
    mod = jg.Modulus64 if dtype == np.uint64 else jg.Modulus32
    f = jg.NTTFactors(mod(q), *jg.ntt_root_pair(q, logn))
    return jg.NTTParameters4Step(logn, JMINUS, dtype=dtype, factors=f)


@pytest.mark.parametrize("cell", R.FOURSTEP + R.COLMAT, ids=lambda c: R.name(*c))
def test_dist_fourstep_matches_golden(ranks, cell):
    """Forward: row b of the gathered (B, n2, n1) spectrum is
    NTT4StepCPU.ntt of row b; inverse: a random spectrum's gathered
    (B, n1, n2) block is NTT4StepCPU.intt of it."""
    dtype, dp, sp, logn = cell
    dt = R.DTYPES[dtype]
    p = jparams(logn, dt)
    gen = jg.NTT4StepCPU(p)
    x = R.inputs(logn, [p.modulus.value], (R.BATCH, p.n)).astype(dt)
    s = R.inputs(logn + 1, [p.modulus.value], (R.BATCH, p.n)).astype(dt)
    fwd = ranks(R.name("fwd", *cell)).reshape(R.BATCH, p.n)
    inv = ranks(R.name("inv", *cell)).reshape(R.BATCH, p.n)
    for b in range(R.BATCH):
        np.testing.assert_array_equal(fwd[b].astype(dt), gen.ntt(x[b]))
        np.testing.assert_array_equal(inv[b].astype(dt), gen.intt(s[b]))


@pytest.mark.parametrize("dtype,count", R.RNS, ids=lambda c: str(c))
def test_dist_rns_fourstep_matches_golden(ranks, dtype, count):
    """Row b under member b % count: the forward and inverse against
    that member's NTT4StepCPU, and DistRNSPolynomialMultiplier.step_lanes
    against its ntt, mult, intt."""
    dt = R.DTYPES[dtype]
    qs = [m.modulus.value for m in R.members(dtype, count)]
    gens = [jg.NTT4StepCPU(jparams(12, dt, q)) for q in qs]
    n = 1 << 12
    x, y, s = (R.inputs(count + k, qs, (R.BATCH, n)).astype(dt) for k in range(3))
    got = {k: ranks(R.name("rns", k, dtype, count)).reshape(R.BATCH, n).astype(dt)
           for k in ("fwd", "inv", "prod")}
    for b in range(R.BATCH):
        gen = gens[b % count]
        np.testing.assert_array_equal(got["fwd"][b], gen.ntt(x[b]))
        np.testing.assert_array_equal(got["inv"][b], gen.intt(s[b]))
        np.testing.assert_array_equal(got["prod"][b],
                                      gen.intt(gen.mult(gen.ntt(x[b]), gen.ntt(y[b]))))


@pytest.mark.parametrize("dtype,chunks", R.MODELS, ids=lambda c: str(c))
def test_dist_model_matches_golden_and_schoolbook(ranks, dtype, chunks):
    """DistPolynomialMultiplier.step_lanes at 2^13 on 2 x 2 (u64: K7''s
    plain version on the columns) against the golden ntt, mult, intt for
    every row, and (u32, where it takes a second) the schoolbook product."""
    dt = R.DTYPES[dtype]
    p = jparams(13, dt)
    gen = jg.NTT4StepCPU(p)
    x, y = (R.inputs(k, [p.modulus.value], (R.BATCH, p.n)).astype(dt) for k in (5, 6))
    got = ranks(R.name("model", dtype, chunks)).reshape(R.BATCH, p.n).astype(dt)
    for b in range(R.BATCH):
        np.testing.assert_array_equal(got[b], gen.intt(gen.mult(gen.ntt(x[b]), gen.ntt(y[b]))))
    if dt == np.uint32:
        np.testing.assert_array_equal(got[0], jg.schoolbook_poly_multiplication(
            x[0], y[0], p.modulus, JMINUS))


def test_collective_bytes_are_counted(ranks):
    """collective_bytes' count equals what each rank handed the all_to_all
    in one dist_fourstep_ntt (u64 2^13, batch 4, on 2 x 2)."""
    for r in range(4):
        assert int(ranks(f"bytes_fourstep_rank{r}")) == collective_bytes(
            "fourstep", 13, 2, batch=R.BATCH, dp=2) == 8 * 2 * (1 << 12) // 2


# ----------------------------------------------- world size 1, in this process


@pytest.fixture(scope="module")
def mesh1():
    """A gloo world of one rank (a HashStore) and its 1 x 1 mesh."""
    with pytest.raises(tg.NTTDeviceError):
        M.make_mesh(device="cpu")  # no group yet
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield M.make_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype,logn", [(np.uint64, 12), (np.uint64, 16), (np.uint32, 14)])
def test_world_one_fourstep_equals_single_chip(mesh1, dtype, logn):
    p = tg.NTTParameters4Step(logn, tg.ReductionPolynomial.X_N_minus, dtype)
    dplan = DistFourStepPlan.from_params(p, device="cpu")
    single = tg.FourStepPlan.from_params(p, device="cpu")
    x = torch.from_numpy(R.inputs(logn, [p.modulus.value], (2, p.n)).view(np.int64))
    spec = dist_fourstep_ntt(x.view(2, p.n1, p.n2), dplan, mesh1)
    assert torch.equal(spec.reshape(2, p.n), tg.fourstep_ntt_full(x, single))
    back = dist_fourstep_intt(spec, dplan, mesh1)
    assert torch.equal(back.reshape(2, p.n), tg.fourstep_intt_full(spec.reshape(2, p.n), single))


@pytest.mark.parametrize("poly", [tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus])
@pytest.mark.parametrize("dtype,logn", [(np.uint64, 13), (np.uint32, 12), (np.uint64, 18)])
def test_world_one_merge_equals_single_chip(mesh1, dtype, logn, poly):
    """At sp = 1 the tail is the whole ring (from_eval; the big-ring plan at
    2^18): dist_merge_ntt / _intt equal ntt_lanes / intt_lanes."""
    p = tg.NTTParameters(logn, poly, dtype)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = torch.from_numpy(R.inputs(logn, [p.modulus.value], (2, p.n)).view(np.int64))
    f = dist_merge_ntt(x, plan, mesh1)
    assert torch.equal(f, tg.ntt_lanes(x, plan))
    assert torch.equal(dist_merge_intt(x, plan, mesh1), tg.intt_lanes(x, plan))


def test_world_one_rns_and_models_equal_single_chip(mesh1):
    ms = R.members("u64", 3)
    qs = [m.modulus.value for m in ms]
    p0 = ms[0]
    x, y = (torch.from_numpy(R.inputs(k, qs, (3, p0.n)).view(np.int64)) for k in (1, 2))
    single = tg.RNSFourStepPlan.from_params(ms, device="cpu")
    dplan = DistRNSFourStepPlan.from_members(ms, device="cpu")
    spec = dist_rns_fourstep_ntt(x.view(3, p0.n1, p0.n2), dplan, mesh1, [0, 1, 2])
    assert torch.equal(spec.reshape(3, -1), tg.rns_fourstep_ntt_full(x, single, [0, 1, 2]))
    back = dist_rns_fourstep_intt(spec, dplan, mesh1, [0, 1, 2])
    assert torch.equal(back.reshape(3, -1), x)
    merges = [tg.NTTParameters(12, tg.ReductionPolynomial.X_N_minus, np.uint64,
                               factors=tg.NTTFactors(tg.Modulus64(q), *tg.ntt_root_pair(q, 12)))
              for q in qs]
    prod = DistRNSPolynomialMultiplier(ms, mesh1).step_lanes(
        x.view(3, p0.n1, p0.n2), y.view(3, p0.n1, p0.n2), [0, 1, 2])
    want = tg.rns_polymul(x.numpy().view(np.uint64), y.numpy().view(np.uint64),
                          tg.RNSMergePlan.from_params(merges, device="cpu"))
    np.testing.assert_array_equal(prod.reshape(3, -1).numpy().view(np.uint64), want)
    x0, y0 = x % qs[0], y % qs[0]
    got = DistPolynomialMultiplier(p0, mesh1)(x0.view(3, p0.n1, p0.n2), y0.view(3, p0.n1, p0.n2))
    single = tg.MergePlan.from_params(merges[0], device="cpu")
    assert torch.equal(got.reshape(3, -1), tg.polymul_lanes(x0, y0, single))


def test_mesh_refusals(mesh1):
    with pytest.raises(tg.NTTDeviceError):
        M.make_mesh(1, 1, device="cuda")  # a gloo group serves no card
    with pytest.raises(ValueError):
        M.make_mesh(2, 1, device="cpu")
    p = tg.NTTParameters4Step(12, tg.ReductionPolynomial.X_N_minus, np.uint64)
    dplan = DistFourStepPlan.from_params(p, device="cpu")
    with pytest.raises(ValueError):
        dist_fourstep_ntt(torch.zeros((1, p.n2, p.n1), dtype=torch.int64), dplan, mesh1)
    with pytest.raises(ValueError):
        dist_fourstep_ntt(torch.zeros((1, p.n1, p.n2), dtype=torch.int64), dplan, mesh1,
                          local_engine="vpu")


def test_entries_default_to_the_card():
    """Without device=, plans and meshes are made for the card: on a host
    without one they raise NTTDeviceError; the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = tg.NTTParameters4Step(12, tg.ReductionPolynomial.X_N_minus, np.uint64)
    with pytest.raises(tg.NTTDeviceError):
        DistFourStepPlan.from_params(p)
    with pytest.raises(tg.NTTDeviceError):
        DistRNSFourStepPlan.from_members([p])
    with pytest.raises(tg.NTTDeviceError):
        dryrun_multichip(1)


# ----------------------------------------------------------- the rest


def test_dryrun_on_four_ranks(capfd):
    """dryrun_multichip(4, device="cpu") at reduced rings (2^12-2^14)
    prints the JAX round's seven lines."""
    dryrun_multichip(4, device="cpu", reduced=True)
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip OK")]
    assert [ln.split("]")[0] + "]" for ln in lines] == [
        "dryrun_multichip OK [4-step all_to_all]",
        "dryrun_multichip OK [merge collective_permute]",
        "dryrun_multichip OK [RNS 4-step all_to_all]",
        "dryrun_multichip OK [merge north-star]",
        "dryrun_multichip OK [RNS 4-step north-star]",
        "dryrun_multichip OK [4-step north-star]",
        "dryrun_multichip OK [4-step north-star]"]


@pytest.mark.parametrize("dtype,logn", [(np.uint64, 13), (np.uint64, 16), (np.uint32, 13)])
def test_from_jax_equals_from_params(dtype, logn):
    """DistFourStepPlan.from_jax of a JAX DistFourStepPlan gives the plan
    from_params builds, table for table: the base plan's, the W and
    chain-inverse W columns of every rank at sp = 1, 2 and 4, and colmat's
    (K7') column plan and W tile and scale tables."""
    from gpuntt_tpu.parallel.fourstep_dist import DistFourStepPlan as JDist

    jd = JDist.from_params(jg.NTTParameters4Step(logn, JMINUS, dtype=dtype))
    carried = DistFourStepPlan.from_jax(jd, device="cpu")
    own = DistFourStepPlan.from_params(
        tg.NTTParameters4Step(logn, tg.ReductionPolynomial.X_N_minus, dtype), device="cpu")
    for name in tf._TABLES:
        assert torch.equal(getattr(carried.base, name), getattr(own.base, name)), name
    assert (carried.base.root, carried.base.iroot, carried.base.n_inv) == (
        own.base.root, own.base.iroot, own.base.n_inv)
    for sp in (1, 2, 4):
        for r in range(sp):
            for a, b in zip(carried.w_local(sp, r), own.w_local(sp, r)):
                assert torch.equal(a, b), (sp, r)
    assert (carried.colmat is None) == (own.colmat is None) == (dtype == np.uint32)
    if own.colmat is not None:
        for name in ("wt_fwd", "wt_fwd_shoup", "ws_fwd", "ws_fwd_shoup", "wt_inv",
                     "wt_inv_shoup", "ws_inv", "ws_inv_shoup"):
            assert torch.equal(getattr(carried.colmat, name), getattr(own.colmat, name)), name
        for name in ("fwd_table", "inv_table"):
            assert torch.equal(getattr(carried.colmat.col, name), getattr(own.colmat.col, name))
        assert carried.colmat.col.n_inv == own.colmat.col.n_inv == 1
        assert own.colmat.rows is None and own.colmat.nested is None


def test_rns_from_jax_equals_from_members():
    from gpuntt_tpu.parallel.fourstep_rns_dist import DistRNSFourStepPlan as JDist

    qs = [m.modulus.value for m in R.members("u64", 3)]
    jd = JDist.from_members([jparams(12, np.uint64, q) for q in qs])
    carried = DistRNSFourStepPlan.from_jax(jd, device="cpu")
    own = DistRNSFourStepPlan.from_members(R.members("u64", 3), device="cpu")
    for a, b in zip(carried.base.members, own.base.members):
        for name in tf._TABLES:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    for sp, r in ((1, 0), (2, 1)):
        for wa, wb in zip(carried.w_local(sp, r), own.w_local(sp, r)):
            assert all(torch.equal(u, v) for u, v in zip(wa, wb))


def test_dist_models_refuse_negacyclic_as_jax_does():
    from gpuntt_tpu.models.polymul import DistPolynomialMultiplier as JModel
    from gpuntt_tpu.models.polymul import DistRNSPolynomialMultiplier as JRNSModel
    from gpuntt_tpu.parallel.mesh import make_mesh

    jp = jg.NTTParameters4Step(12, jg.ReductionPolynomial.X_N_plus, dtype=np.uint64)
    tp = tg.NTTParameters4Step(12, tg.ReductionPolynomial.X_N_plus, np.uint64)
    jmesh = make_mesh(dp=1, sp=8)
    for model, params, mesh in ((JModel, jp, jmesh), (DistPolynomialMultiplier, tp, None)):
        with pytest.raises(ValueError):
            model(params, mesh)
    for model, params, mesh in ((JRNSModel, jp, jmesh), (DistRNSPolynomialMultiplier, tp, None)):
        with pytest.raises(ValueError):
            model([params], mesh)


# --------------------------------------- against the JAX dist functions (slow)


def _jax_dist(fn, x, mesh, spec, is64, *args):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpuntt_tpu.ops.merge_ntt import from_lanes, to_lanes

    lanes = jax.tree_util.tree_map(lambda a: jax.device_put(a, NamedSharding(mesh, P(*spec))),
                                   to_lanes(x, is64))
    return from_lanes(fn(lanes, *args), is64)


@pytest.mark.slow
def test_dist_fourstep_against_jax_dist(ranks):
    """The u32 2^12 cell on 2 x 2 against gpuntt_tpu's dist_fourstep_ntt
    and dist_fourstep_intt (XLA local engine; minutes of XLA compiles)."""
    from gpuntt_tpu.parallel import fourstep_dist as jfd
    from gpuntt_tpu.parallel.mesh import make_mesh

    p = jparams(12, np.uint32)
    jd = jfd.DistFourStepPlan.from_params(p)
    mesh = make_mesh(dp=2, sp=2)
    x = R.inputs(12, [p.modulus.value], (R.BATCH, p.n1, p.n2)).astype(np.uint32)
    s = R.inputs(13, [p.modulus.value], (R.BATCH, p.n2, p.n1)).astype(np.uint32)
    cell = ("u32", 2, 2, 12)
    fwd = _jax_dist(lambda v: jfd.dist_fourstep_ntt(v, jd, mesh, local_engine="xla"), x, mesh,
                    ("dp", None, "sp"), False)
    inv = _jax_dist(lambda v: jfd.dist_fourstep_intt(v, jd, mesh, local_engine="xla"), s, mesh,
                    ("dp", None, "sp"), False)
    np.testing.assert_array_equal(ranks(R.name("fwd", *cell)).astype(np.uint32), fwd)
    np.testing.assert_array_equal(ranks(R.name("inv", *cell)).astype(np.uint32), inv)


@pytest.mark.slow
def test_dist_rns_fourstep_against_jax_dist(ranks):
    """The u32 ladder-3 cell against gpuntt_tpu's dist_rns_fourstep_ntt."""
    from gpuntt_tpu.parallel import fourstep_rns_dist as jrd
    from gpuntt_tpu.parallel.mesh import make_mesh

    qs = [m.modulus.value for m in R.members("u32", 3)]
    jd = jrd.DistRNSFourStepPlan.from_members([jparams(12, np.uint32, q) for q in qs])
    mesh = make_mesh(dp=2, sp=2)
    p0 = jd.base
    x = R.inputs(3, qs, (R.BATCH, p0.n1, p0.n2)).astype(np.uint32)
    mod_idx = np.arange(R.BATCH) % 3
    fwd = _jax_dist(lambda v: jrd.dist_rns_fourstep_ntt(v, jd, mesh, mod_idx, local_engine="xla"),
                    x, mesh, ("dp", None, "sp"), False)
    np.testing.assert_array_equal(ranks(R.name("rns", "fwd", "u32", 3)).astype(np.uint32), fwd)
