"""The port's RNS merge path against gpuntt_tpu's (CPU, exact equality).

- The public RNS entries (ntt_rns, intt_rns, the modulus- and
  poly-ordered schedules, rns_polymul) against the JAX package's XLA
  RNS engine, run under one jit per cell with the schedule a traced
  argument: u64 and u32, both reduction polynomials, logn 10-14 and
  17-18, ladders 1-3, cyclic and ordered schedules, poly_ordered with a
  batch_size below the batch and a repeated row.  The port takes
  device="cpu", so the plain versions of K12, K13 and the stacked u32
  kernels run where dispatch routes the kernels.
- The JAX package's own public entries at logn 12: the out-of-range
  order [5, -1, 0], a repeated poly_ordered row, rns_pointwise_mult and
  rns_polymul with an order, and the order check.
- rns_pointwise_mult_lanes on schedules that name no member, the JAX
  where-chain's reading.
- RNSPolynomialMultiplier against the JAX model, its CRT lift against a
  big-integer schoolbook, its buffers and shape check.
- RNSMergePlan.from_arrays against from_params, the route table, and the
  big-ring plans (logn 18-23) that hold no N-entry table.

Inputs are canonical residues from numpy seeds; nothing above logn 18 is
transformed here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
from gpuntt_tpu.ops.limb import u64_to_numpy
from gpuntt_tpu.ops.merge_ntt import from_lanes as jfrom
from gpuntt_tpu.ops.merge_ntt import to_lanes as jto
from gpuntt_tpu.ops.rns import rns_intt_lanes as j_intt
from gpuntt_tpu.ops.rns import rns_ntt_lanes as j_ntt
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops.merge_ntt import from_lanes, to_lanes
from gpuntt_tpu_torch.ops.rns import schedule_index

torch.set_num_threads(2)

MINUS, PLUS = jg.ReductionPolynomial.X_N_minus, jg.ReductionPolynomial.X_N_plus


def ladder(pkg, logn, mc, poly, dtype, bits=None):
    """`mc` found primes of `bits` bits (59 for u64, 28 for u32) with
    their root pairs, as NTTParameters of package `pkg`."""
    is64 = dtype == np.uint64
    bits = bits or (59 if is64 else 28)
    mod = pkg.Modulus64 if is64 else pkg.Modulus32
    out = []
    for q in pkg.find_ntt_primes(bits, logn, mc):
        omega, psi = pkg.ntt_root_pair(q, logn)
        out.append(pkg.NTTParameters(logn, pkg.ReductionPolynomial(poly.value), dtype,
                                     factors=pkg.NTTFactors(mod(q), omega, psi)))
    return out


@functools.cache
def plans(dtype, logn, poly, mc, bits=None):
    """(JAX plan, port plan) of one ladder, cached: the JAX jit caches by
    the plan's members."""
    jm = ladder(jg, logn, mc, poly, dtype, bits)
    return (jg.RNSMergePlan.from_params(jm),
            tg.RNSMergePlan.from_params(ladder(tg, logn, mc, poly, dtype, bits), device="cpu"))


def data(qs, shape, seed, dtype):
    """Residues below the smallest q: canonical under every member."""
    return np.random.default_rng(seed).integers(0, min(qs), size=shape,
                                                dtype=np.uint64).astype(dtype)


@jax.jit
def _jax_engine(v, plan, mod_idx):
    """The JAX package's XLA RNS engine, forward and inverse; the schedule
    is traced, so one compile serves every schedule of a cell."""
    return j_ntt(v, plan, mod_idx), j_intt(v, plan, mod_idx)


def jax_ref(x, jplan, mod_idx):
    is64 = jplan.is64
    f, i = _jax_engine(jto(x, is64), jplan, jnp.asarray(mod_idx, dtype=jnp.int32))
    return jfrom(f, is64).astype(x.dtype), jfrom(i, is64).astype(x.dtype)


# ------------------------------------------------- entries against JAX

CELLS = [  # dtype, logn, poly, ladder, route
    (np.uint64, 10, MINUS, 1, "engine"),
    (np.uint64, 12, PLUS, 3, "hopper-rns"),
    (np.uint64, 14, MINUS, 2, "hopper-rns"),
    (np.uint64, 17, PLUS, 2, "hopper-rns"),
    (np.uint64, 18, MINUS, 3, "hopper-rns-large"),
    (np.uint32, 12, PLUS, 3, "hopper-rns32"),
    (np.uint32, 14, MINUS, 2, "hopper-rns32"),
]


@pytest.mark.parametrize("dtype,logn,poly,mc,route", CELLS)
def test_entries_match_jax(dtype, logn, poly, mc, route):
    """Every entry at logn <= 14; the cyclic ones and rns_polymul at 17
    and 18, where a transform of the plain versions takes a second."""
    jplan, plan = plans(dtype, logn, poly, mc)
    batch = mc + 1
    x = data(plan.qs, (batch, plan.n), logn, dtype)
    y = data(plan.qs, (batch, plan.n), logn + 1, dtype)
    assert td._rns_kernel_path(plan, x.shape) == route
    hr.reset_counts()
    hr32.reset_counts()

    cyclic = np.arange(batch) % mc
    fx, ix = jax_ref(x, jplan, cyclic)
    np.testing.assert_array_equal(tg.ntt_rns(x, plan), fx)
    np.testing.assert_array_equal(tg.intt_rns(x, plan), ix)

    if logn <= 14:
        order = np.arange(mc)[::-1]  # the ladder reversed
        f2, i2 = jax_ref(x, jplan, order[np.arange(batch) % mc])
        np.testing.assert_array_equal(tg.ntt_modulus_ordered(x, plan, order), f2)
        np.testing.assert_array_equal(tg.intt_modulus_ordered(x, plan, order), i2)
        # rows [1, 0, 1] with batch_size 3: row 1 repeats, its last occurrence
        # (schedule position 2, modulus 2 % mc) wins; row 0 takes modulus 1 % mc
        f3, i3 = jax_ref(x, jplan, np.arange(1, batch + 1) % mc)
        for fn, want in ((tg.ntt_poly_ordered, f3), (tg.intt_poly_ordered, i3)):
            got = fn(x, plan, [1, 0, 1, batch - 1], batch_size=3)
            np.testing.assert_array_equal(got[:2], want[:2])
            np.testing.assert_array_equal(got[2:], x[2:])

    # rns_polymul: the JAX package's composition (ntt_rns, rns_pointwise_mult,
    # intt_rns), the product from its own numpy entry
    fy, _ = jax_ref(y, jplan, cyclic)
    prod = jg.rns_pointwise_mult(fx, fy, jplan)
    np.testing.assert_array_equal(tg.rns_pointwise_mult(fx, fy, plan), prod)
    np.testing.assert_array_equal(tg.rns_polymul(x, y, plan), jax_ref(prod, jplan, cyclic)[1])

    plain = sum(k.plain_calls for k in (*hr.KERNELS, *hr32.KERNELS))
    assert (plain > 0) == (route != "engine")
    if route == "hopper-rns-large":
        assert hr.LARGE_COLFWD.plain_calls == 3 and hr.LARGE_COLINV.plain_calls == 2
        assert plan.fwd_tables is None and all(m.fwd_table is None for m in plan.members)


def test_public_entries_match_jax_entries():
    """The JAX package's own entries: the out-of-range order (jnp reads
    [5, -1, 0] as [2, 2, 0]), a repeated poly_ordered row (the last wins),
    the pointwise product and polymul with an order, and the order check."""
    jplan, plan = plans(np.uint64, 12, PLUS, 3)
    x = data(plan.qs, (4, plan.n), 5, np.uint64)
    y = data(plan.qs, (4, plan.n), 6, np.uint64)
    assert list(schedule_index([5, -1, 0], 3)) == [2, 2, 0]
    for name in ("ntt_modulus_ordered", "intt_modulus_ordered"):
        np.testing.assert_array_equal(getattr(tg, name)(x, plan, [5, -1, 0]),
                                      getattr(jg, name)(x, jplan, [5, -1, 0]), err_msg=name)
    np.testing.assert_array_equal(tg.ntt_poly_ordered(x, plan, [2, 0, 2], batch_size=3),
                                  jg.ntt_poly_ordered(x, jplan, [2, 0, 2], batch_size=3))
    np.testing.assert_array_equal(tg.rns_pointwise_mult(x, y, plan, order=[2, 0]),
                                  jg.rns_pointwise_mult(x, y, jplan, order=[2, 0]))
    np.testing.assert_array_equal(tg.rns_polymul(x, y, plan, order=[2, 0, 1]),
                                  jg.rns_polymul(x, y, jplan, order=[2, 0, 1]))
    for fn in (tg.rns_polymul, tg.rns_pointwise_mult):
        with pytest.raises(ValueError):
            fn(x, y, plan, order=[3])
        with pytest.raises(ValueError):
            fn(x, y, plan, order=[-1])


def test_ladder_16_under_both_ordered_schedules_against_golden():
    """A ladder of 16 at logn 12 (K12's plain versions), each row against
    NTTCPU of the member its schedule names: ntt/intt_modulus_ordered with
    a permuted order, ntt/intt_poly_ordered on a permutation of 32 rows
    with batch_size 20."""
    members = ladder(tg, 12, 16, PLUS, np.uint64)
    plan = tg.RNSMergePlan.from_params(members, device="cpu")
    gens = [tg.NTTCPU(p) for p in members]
    rng = np.random.default_rng(16)
    order = rng.permutation(16)
    x = data(plan.qs, (32, plan.n), 16, np.uint64)
    fx = tg.ntt_modulus_ordered(x, plan, order)
    for b in range(32):
        np.testing.assert_array_equal(fx[b], gens[order[b % 16]].ntt(x[b]))
    np.testing.assert_array_equal(tg.intt_modulus_ordered(fx, plan, order), x)
    rows = rng.permutation(32)
    for fn, golden in ((tg.ntt_poly_ordered, "ntt"), (tg.intt_poly_ordered, "intt")):
        got = fn(x, plan, rows, batch_size=20)
        for b in range(32):
            want = (getattr(gens[b % 16], golden)(x[rows[b]]) if b < 20 else x[rows[b]])
            np.testing.assert_array_equal(got[rows[b]], want)


@pytest.mark.parametrize("mod_idx", [[0, 1, 2, 1], [2, 5, -1, 0]])
def test_pointwise_lanes_match_jax_lanes(mod_idx):
    """Rows whose entry names no member 1..mod_count-1 (5, -1) take
    member 0's product, as the JAX where-chain leaves them."""
    from gpuntt_tpu.ops.dispatch import rns_pointwise_mult_lanes as j_pw

    jplan, plan = plans(np.uint64, 12, PLUS, 3)
    a = data(plan.qs, (4, plan.n), 8, np.uint64)
    b = data(plan.qs, (4, plan.n), 9, np.uint64)
    want = jfrom(jax.jit(lambda u, v: j_pw(u, v, jplan, np.array(mod_idx)))(
        jto(a, True), jto(b, True)), True)
    got = tg.rns_pointwise_mult_lanes(to_lanes(a, True), to_lanes(b, True), plan, mod_idx)
    np.testing.assert_array_equal(from_lanes(got, True), want)


# ----------------------------------------------------------------- model


def test_model_matches_jax_model():
    from gpuntt_tpu.models.polymul import RNSPolynomialMultiplier

    jplan, _ = plans(np.uint64, 12, PLUS, 3)  # its members host the JAX jit caches
    jmodel = RNSPolynomialMultiplier(jplan.members)
    model = tg.RNSPolynomialMultiplier(ladder(tg, 12, 3, PLUS, np.uint64), device="cpu")
    a = data(model.qs, (1, 3, 1 << 12), 1, np.uint64)
    b = data(model.qs, (1, 3, 1 << 12), 2, np.uint64)
    hr.reset_counts()
    got = model(a, b)
    np.testing.assert_array_equal(got, jmodel(a, b))
    assert hr.POLYMUL_INVERSE.plain_calls == 1 and hr.FORWARD.plain_calls == 2
    np.testing.assert_array_equal(model(np.concatenate([a, a]), np.concatenate([b, b]))[1],
                                  got[0])
    # lane tensors through forward(), and the buffers it registered
    lanes = model(to_lanes(a, True), to_lanes(b, True))
    np.testing.assert_array_equal(from_lanes(lanes, True), got)
    assert {n for n, _ in model.named_buffers()} == {"fwd_tables", "fwd_shoup", "inv_tables",
                                                      "inv_shoup", "consts"}
    assert model.fwd_tables.shape == (3, 1 << 12)
    for bad in ((a[:, :2], b[:, :2]), (a, b[..., :-1]), (a[0, 0], b[0, 0])):
        with pytest.raises(ValueError):
            model(*bad)
    model.to("meta")  # in place
    assert model.plan.device == torch.device("meta")
    assert model.plan.members[1].fwd_table.device == torch.device("meta")


def test_model_crt_lifts_to_bigint_product():
    """Residue-wise cyclic convolution == big-integer schoolbook mod
    Q = prod(q_i) (tests/test_rns_polymul.py's property, on the port)."""
    logn, mc = 6, 3
    members = ladder(tg, logn, mc, MINUS, np.uint64)
    model = tg.RNSPolynomialMultiplier(members, device="cpu")
    qs = model.qs
    big_q = int(np.prod([int(q) for q in qs], dtype=object))
    n = 1 << logn
    rng = np.random.default_rng(3)
    a_int = [int(v) for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    b_int = [int(v) for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    a = np.stack([np.array([v % q for v in a_int], dtype=np.uint64) for q in qs])
    b = np.stack([np.array([v % q for v in b_int], dtype=np.uint64) for q in qs])
    want = [0] * n
    for i in range(n):
        for j in range(n):
            want[(i + j) % n] = (want[(i + j) % n] + a_int[i] * b_int[j]) % big_q
    assert tg.crt_reconstruct(model(a, b), qs) == want
    batched = model(np.stack([a, a]), np.stack([b, b]))
    assert batched.shape == (2, mc, n)
    np.testing.assert_array_equal(batched[0], batched[1])


def test_big_ring_model_registers_no_table():
    model = tg.RNSPolynomialMultiplier(ladder(tg, 20, 2, PLUS, np.uint64), device="cpu")
    assert {n for n, _ in model.named_buffers()} == {"consts"}
    assert model.plan.fwd_tables is None and "large" not in model.plan._lazy


# ----------------------------------------------------------- plans, routes


@pytest.mark.parametrize("dtype", [np.uint64, np.uint32])
def test_from_arrays_equals_from_params(dtype):
    """A port plan carried across from a JAX RNSMergePlan's stacked arrays
    gives what from_params gives."""
    jplan, own = plans(dtype, 12, PLUS, 3)
    arr = u64_to_numpy if dtype == np.uint64 else np.asarray
    ms = jplan.members
    carried = tg.RNSMergePlan.from_arrays(
        jplan.qs, jplan.logn, jplan.reduction_poly, [m.root_of_unity for m in ms],
        [m.inverse_root_of_unity for m in ms], [m.n_inv for m in ms],
        arr(jplan.fwd_tables), arr(jplan.inv_tables), device="cpu", dtype=dtype)
    for name in ("fwd_tables", "fwd_shoup", "inv_tables", "inv_shoup", "consts"):
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    assert carried.qs == own.qs and carried.is64 == own.is64
    np.testing.assert_array_equal(u64_to_numpy(jplan.fwd_shoup) if dtype == np.uint64
                                  else np.asarray(jplan.fwd_shoup),
                                  from_lanes(own.fwd_shoup, dtype == np.uint64))
    x = data(own.qs, (3, own.n), 4, dtype)
    np.testing.assert_array_equal(tg.ntt_rns(x, carried), tg.ntt_rns(x, own))
    # members are views of the stacks
    assert carried.members[2].inv_table.data_ptr() == carried.inv_tables[2].data_ptr()


def test_plans_refuse_mixed_members():
    a = ladder(tg, 12, 1, PLUS, np.uint64)[0]
    with pytest.raises(ValueError):
        tg.RNSMergePlan.from_params([a, ladder(tg, 13, 1, PLUS, np.uint64)[0]], device="cpu")
    with pytest.raises(ValueError):
        tg.RNSMergePlan.from_params([a, ladder(tg, 12, 1, MINUS, np.uint64)[0]], device="cpu")
    with pytest.raises(ValueError):
        tg.RNSMergePlan.from_params([a, ladder(tg, 12, 1, PLUS, np.uint32)[0]], device="cpu")


def test_route_table():
    def route(logn, dtype=np.uint64, bits=None, shape=None, mc=2):
        plan = tg.RNSMergePlan.from_params(ladder(tg, logn, mc, PLUS, dtype, bits),
                                           device="cpu")
        return td._rns_kernel_path(plan, shape or (mc, plan.n))

    assert [route(k) for k in (11, 12, 17, 18, 23, 24)] == [
        "engine", "hopper-rns", "hopper-rns", "hopper-rns-large", "hopper-rns-large",
        "engine"]
    assert route(12, bits=62) == "hopper-rns" and route(12, bits=63) == "engine"
    assert route(12, np.uint32) == "hopper-rns32" and route(13, np.uint32) == "hopper-rns32"
    assert route(7, np.uint32) == "engine" and route(12, np.uint32, bits=31) == "engine"
    assert route(12, shape=(1, 2, 1 << 12)) == "engine"
    # a member whose factors are no root of unity takes the engine
    odd = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus, np.uint64,
                           factors=tg.NTTFactors(tg.Modulus64(576460752303415297), 5, 7))
    plan = tg.RNSMergePlan.from_params([ladder(tg, 12, 1, PLUS, np.uint64)[0], odd],
                                       device="cpu")
    assert td._rns_kernel_path(plan, (2, plan.n)) == "engine"


@pytest.mark.parametrize("logn", [18, 23])
def test_big_ring_plans_build_no_n_entry_table(logn):
    """At logn 18-23 neither the RNS plan nor its members hold an N-entry
    table, and K13's stacked plan has no table above 2^17 entries per
    modulus, its W tile table (A, T) = (128, 1024) the largest (the
    N-entry tables would be 2 GiB at 2^23 with a ladder of 8)."""
    plan = tg.RNSMergePlan.from_params(ladder(tg, logn, 2, PLUS, np.uint64), device="cpu")
    assert plan.fwd_tables is None and all(m.fwd_table is None for m in plan.members)
    sp = hr.large_plan(plan)
    assert hr.large_plan(plan) is sp
    assert all(m.fwd_table is None and not m._lazy for m in plan.members)
    lp = sp.first
    assert (lp.A, lp.B) == (128, 1 << (logn - 7))
    tables = (sp.col.fwd_tables, sp.rows.fwd_tables, sp.wt_fwd, sp.ws_fwd, sp.wt_inv,
              sp.ws_inv)
    assert max(t[0].numel() for t in tables) <= 1 << 17
    moved = plan.to("meta")
    assert moved._lazy["large"].device == torch.device("meta")
    assert moved._lazy["large"].first.rows.fwd_table.device == torch.device("meta")


def test_plan_defaults_to_the_card():
    members = ladder(tg, 12, 2, PLUS, np.uint64)
    if torch.cuda.is_available():
        assert tg.RNSMergePlan.from_params(members).device.type == "cuda"
    else:
        with pytest.raises(tg.NTTDeviceError):
            tg.RNSMergePlan.from_params(members)
    plan = tg.RNSMergePlan.from_params(members, device="cpu")
    assert plan.to("cpu") is plan
    meta = plan.to("meta")
    assert meta.fwd_tables.device == torch.device("meta") and plan.to("meta") is meta
    assert meta.members[0].fwd_table.device == torch.device("meta")
