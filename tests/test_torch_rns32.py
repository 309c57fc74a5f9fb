"""The port's u32 RNS path against gpuntt_tpu's (CPU, exact equality).

- The stacked u32 kernels' plain versions (ops/hopper_rns32.py) against
  the Pallas kernel they replace, K16 (pallas_mxu32_rns), in interpret
  mode at the JAX test's cell (tests/test_mxu_rns.py:108-142: logn 12,
  X^N + 1, the ladder 268460033 / 268582913 / 268664833, five rows on
  the schedule [1, 2, 0, 2, 1]).
- The public u32 entries (ntt_rns, intt_rns, both ordered schedules,
  rns_polymul, RNSPolynomialMultiplier) against the JAX package's XLA
  RNS engine at logn 8, 12, 14 and 18, both reduction polynomials; the
  port takes device="cpu", so the kernels' plain versions run where
  dispatch routes the kernels (K16's range up to logn 17, K6's above).
- A JAX u32 RNSMergePlan carried across by RNSMergePlan.from_arrays.
- merge_u32.cu's rns_u32_* entries compiled by g++ through
  test_torch_merge.py's host emulation, against the plain versions: at
  logn 8 (blocks of one ring, neighbouring rings under different
  moduli), 14 and 18, on schedules of one entry per ring and per two
  rings, and the schedules the entries refuse.
- The wrappers' contract: plain versions for CPU tensors only, errors
  for other devices, schedules and plans the kernels do not take.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops import pallas_mxu_rns as pr
from gpuntt_tpu.ops.rns import rns_intt_lanes as j_intt
from gpuntt_tpu.ops.rns import rns_ntt_lanes as j_ntt
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes
from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus


def members(pkg, logn, poly, qs):
    out = []
    for q in qs:
        omega, psi = pkg.ntt_root_pair(q, logn)
        out.append(pkg.NTTParameters(logn, pkg.ReductionPolynomial(poly.value), np.uint32,
                                     factors=pkg.NTTFactors(pkg.Modulus32(q), omega, psi)))
    return out


@functools.cache
def primes(logn, mc):
    """`mc` 30-bit NTT primes for logn (every q < 2^30)."""
    return tuple(tg.find_ntt_primes(30, logn, mc))


@functools.cache
def plans(logn, poly, mc):
    """(JAX plan, port plan) of a ladder of `mc` 30-bit primes, cached:
    the JAX jit caches by the plan's members."""
    qs = primes(logn, mc)
    return (jg.RNSMergePlan.from_params(members(jg, logn, poly, qs)),
            tg.RNSMergePlan.from_params(members(tg, logn, poly, qs), device="cpu"))


def residues(qs, mod_idx, n, seed):
    """Row b canonical under modulus mod_idx[b]."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, qs[m], n, dtype=np.uint64) for m in mod_idx]
                    ).astype(np.uint32)


def words(shape, seed):
    """Any u32 words: the kernels reduce their input first."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                                 dtype=np.int64))


def sched(mod_idx):
    return torch.tensor(mod_idx, dtype=torch.int32)


def plain_calls():
    return {k.name: k.plain_calls for k in hr32.KERNELS if k.plain_calls}


# ---------------------------------------- plain versions against Pallas


def test_k16_plain_matches_pallas():
    qs = (268460033, 268582913, 268664833)
    rplan = pr.MXU32RNSPlan.from_members(members(jg, 12, PLUS, qs))
    plan = tg.RNSMergePlan.from_params(members(tg, 12, PLUS, qs), device="cpu")
    mod_idx = [1, 2, 0, 2, 1]
    x = residues(qs, mod_idx, plan.n, 1)
    fx = np.asarray(pr.pallas_mxu32_rns(jnp.asarray(x), rplan, np.array(mod_idx),
                                        interpret=True))
    got = hr32.rns_u32_fwd_plain(to_lanes(x, False), plan, sched(mod_idx))
    np.testing.assert_array_equal(from_lanes(got, False), fx)
    ix = np.asarray(pr.pallas_mxu32_rns(jnp.asarray(fx), rplan, np.array(mod_idx),
                                        inverse=True, interpret=True))
    got = hr32.rns_u32_inv_plain(to_lanes(fx, False), plan, sched(mod_idx))
    np.testing.assert_array_equal(from_lanes(got, False), ix)
    np.testing.assert_array_equal(ix, x)


# ------------------------------------------------- entries against JAX


@jax.jit
def _jax_engine(v, plan, mod_idx):
    """The JAX package's XLA RNS engine, forward and inverse; the schedule
    is traced, so one compile serves every schedule of a cell."""
    return j_ntt(v, plan, mod_idx), j_intt(v, plan, mod_idx)


def jax_ref(x, jplan, mod_idx):
    f, i = _jax_engine(jnp.asarray(x), jplan, jnp.asarray(mod_idx, dtype=jnp.int32))
    return np.asarray(f), np.asarray(i)


@pytest.mark.parametrize("poly", [MINUS, PLUS])
@pytest.mark.parametrize("logn,mc", [(8, 3), (12, 3), (14, 2), (18, 2)])
def test_entries_match_jax(logn, mc, poly):
    """Every public u32 entry on the route "hopper-rns32" against the
    JAX engine (the ordered entries up to logn 14, where a plain
    transform takes well under a second), and the model against the
    JAX model."""
    from gpuntt_tpu.models.polymul import RNSPolynomialMultiplier

    jplan, plan = plans(logn, poly, mc)
    batch = mc + 1
    low = (min(plan.qs),)  # residues below the smallest q
    x = residues(low, [0] * batch, plan.n, logn)
    y = residues(low, [0] * batch, plan.n, logn + 1)
    assert td._rns_kernel_path(plan, x.shape) == "hopper-rns32"
    hr32.reset_counts()

    cyclic = np.arange(batch) % mc
    fx, ix = jax_ref(x, jplan, cyclic)
    np.testing.assert_array_equal(tg.ntt_rns(x, plan), fx)
    np.testing.assert_array_equal(tg.intt_rns(x, plan), ix)
    if logn <= 14:
        order = np.arange(mc)[::-1]
        f2, i2 = jax_ref(x, jplan, order[np.arange(batch) % mc])
        np.testing.assert_array_equal(tg.ntt_modulus_ordered(x, plan, order), f2)
        np.testing.assert_array_equal(tg.intt_modulus_ordered(x, plan, order), i2)
        # rows [1, 0, 1] with batch_size 3: row 1's last occurrence (position 2) wins
        f3, i3 = jax_ref(x, jplan, np.arange(1, batch + 1) % mc)
        for fn, want in ((tg.ntt_poly_ordered, f3), (tg.intt_poly_ordered, i3)):
            got = fn(x, plan, [1, 0, 1, batch - 1], batch_size=3)
            np.testing.assert_array_equal(got[:2], want[:2])
            np.testing.assert_array_equal(got[2:], x[2:])
    fy, _ = jax_ref(y, jplan, cyclic)
    prod = jg.rns_pointwise_mult(fx, fy, jplan)
    np.testing.assert_array_equal(tg.rns_polymul(x, y, plan), jax_ref(prod, jplan, cyclic)[1])

    k = hr32.tpu_kernel(logn)
    fwd, inv, pinv = (hr32.FORWARD[k].name, hr32.INVERSE[k].name,
                      hr32.POLYMUL_INVERSE[k].name)
    ordered = 2 if logn <= 14 else 0
    assert plain_calls() == {fwd: 3 + ordered, inv: 1 + ordered, pinv: 1}

    model = tg.RNSPolynomialMultiplier(members(tg, logn, poly, plan.qs), device="cpu")
    a = residues(plan.qs, range(mc), plan.n, 3)[None]
    b = residues(plan.qs, range(mc), plan.n, 4)[None]
    hr32.reset_counts()
    # the JAX model on the plan's members, which host its jit caches
    np.testing.assert_array_equal(model(a, b), RNSPolynomialMultiplier(jplan.members)(a, b))
    assert plain_calls() == {fwd: 2, pinv: 1}
    assert model.fwd_tables.shape == (mc, plan.n if poly == PLUS else plan.n // 2)


def test_from_arrays_carries_a_jax_u32_plan():
    """A JAX u32 RNSMergePlan carried across by from_arrays (its uint32
    stacked tables) takes the u32 route and gives the JAX entries'
    outputs."""
    jplan, own = plans(12, MINUS, 3)
    ms = jplan.members
    carried = tg.RNSMergePlan.from_arrays(
        jplan.qs, jplan.logn, jplan.reduction_poly, [m.root_of_unity for m in ms],
        [m.inverse_root_of_unity for m in ms], [m.n_inv for m in ms],
        np.asarray(jplan.fwd_tables), np.asarray(jplan.inv_tables), device="cpu",
        dtype=np.uint32)
    assert not carried.is64 and torch.equal(carried.consts, own.consts)
    assert td._rns_kernel_path(carried, (3, carried.n)) == "hopper-rns32"
    x = residues(carried.qs, [0, 1, 2], carried.n, 5)
    np.testing.assert_array_equal(tg.ntt_rns(x, carried), jg.ntt_rns(x, jplan))
    np.testing.assert_array_equal(tg.rns_polymul(x, x[::-1], carried),
                                  jg.rns_polymul(x, x[::-1], jplan))


# ------------------------------------------------ the CUDA source, emulated


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _emulate(tmp_path_factory, "merge_u32")


def _entry(lib, entry, plan, midx, shift, *xs):
    inverse = entry != "rns_u32_forward"
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(xs[0])
    rc = getattr(lib, entry)(0, *(x.data_ptr() for x in xs), y.data_ptr(), xs[0].shape[0],
                             plan.logn, hm32.split(plan.logn), midx.data_ptr(), midx.numel(),
                             shift, table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(),
                             int(plan.xnp), None)
    assert rc == 0, entry
    return y


@pytest.mark.parametrize("logn,poly", [(8, PLUS), (8, MINUS), (14, MINUS), (18, PLUS)])
def test_source_emulated_matches_plain(emu, logn, poly):
    """The three rns_u32 entries on any u32 word against the plain
    versions: one entry per ring ([2, 0, 1, 1, 0, 2]: at logn 8 a tile of
    one modulus would hold 32 rings, so neighbouring rings of other
    moduli must not share a block) and one per two rings."""
    plan = tg.RNSMergePlan.from_params(members(tg, logn, poly, primes(logn, 3)),
                                       device="cpu")
    for midx, shift in ((sched([2, 0, 1, 1, 0, 2]), 0), (sched([1, 2, 0]), 1)):
        rows = midx.numel() << shift
        x = words((rows, plan.n), logn)
        fa = hr32.rns_u32_fwd_plain(x, plan, midx, shift)
        fb = hr32.rns_u32_fwd_plain(words((rows, plan.n), logn + 1), plan, midx, shift)
        assert torch.equal(_entry(emu, "rns_u32_forward", plan, midx, shift, x), fa)
        assert torch.equal(_entry(emu, "rns_u32_inverse", plan, midx, shift, x),
                           hr32.rns_u32_inv_plain(x, plan, midx, shift))
        assert torch.equal(_entry(emu, "rns_u32_polymul_inverse", plan, midx, shift, fa, fb),
                           hr32.rns_u32_polymul_inv_plain(fa, fb, plan, midx, shift))


def test_source_emulated_refuses_bad_schedules(emu):
    plan = tg.RNSMergePlan.from_params(members(tg, 12, PLUS, primes(12, 2)), device="cpu")
    x = torch.zeros((4, plan.n), dtype=torch.int64)
    midx = sched([1, 0, 1])
    for entries, shift in ((3, 0), (3, 1), (0, 2)):  # 3 or 6 rings named for 4 rows, or none
        rc = emu.rns_u32_forward(0, x.data_ptr(), x.data_ptr(), 4, 12, hm32.split(12),
                                 midx.data_ptr(), entries, shift, plan.fwd_tables.data_ptr(),
                                 plan.fwd_shoup.data_ptr(), plan.consts.data_ptr(), 1, None)
        assert rc == 1  # cudaErrorInvalidValue


# ------------------------------------------------------ wrapper contract


def test_wrappers_take_plain_versions_on_cpu_only():
    plan = tg.RNSMergePlan.from_params(members(tg, 12, PLUS, primes(12, 2)), device="cpu")
    x = words((2, plan.n), 1)
    midx = sched([1, 0])
    hr32.reset_counts()
    hr32.rns_u32_fwd(x, plan, midx)
    hr32.rns_u32_polymul_inv(x, x, plan, midx)
    assert plain_calls() == {"rns_u32_forward_k16": 1, "rns_u32_polymul_inverse_k16": 1}
    assert sum(k.launches for k in hr32.KERNELS) == 0 and "merge_u32" not in _build._libs
    with pytest.raises(tg.NTTDeviceError):
        hr32.rns_u32_fwd(torch.empty((2, plan.n), dtype=torch.int64, device="meta"),
                         plan.to("meta"), midx.to("meta"))
    for bad_x, bad_m in ((x, midx.long()), (x, sched([1, 0, 1])), (x[:, :-1], midx),
                         (x.to(torch.int32), midx), (x.t(), midx)):
        with pytest.raises(tg.NTTDispatchError):
            hr32.rns_u32_fwd(bad_x, plan, bad_m)
    u64 = tg.RNSMergePlan.from_params([tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus,
                                                        np.uint64)], device="cpu")
    wide = tg.RNSMergePlan.from_params(
        members(tg, 12, PLUS, [tg.find_ntt_primes(31, 12, 1)[0]]), device="cpu")
    for bad in (u64, wide):  # a u64 ladder, a q above 2^30
        with pytest.raises(tg.NTTDispatchError):
            hr32.rns_u32_fwd(torch.zeros((1, bad.n), dtype=torch.int64), bad, sched([0]))
    assert td._rns_kernel_path(wide, (1, wide.n)) == "engine"


def test_route_and_counts_by_logn():
    """K16's counts at logn 8-17, K6's at 18-25 (the JAX package's split),
    and the u32 route's bounds: logn 8-25 with every q < 2^30."""
    assert [hr32.tpu_kernel(k) for k in (8, 17, 18, 25)] == ["K16", "K16", "K6", "K6"]

    def route(logn, bits=30):
        qs = tg.find_ntt_primes(bits, logn, 2)
        plan = tg.RNSMergePlan.from_params(members(tg, logn, PLUS, qs), device="cpu")
        return td._rns_kernel_path(plan, (2, plan.n))

    assert [route(k) for k in (7, 8, 13, 17, 18)] == [
        "engine", "hopper-rns32", "hopper-rns32", "hopper-rns32", "hopper-rns32"]
    assert route(12, bits=31) == "engine"
