"""The port's distributed merge NTT, its per-rank tail plans and K7',
held bit-exact against the JAX package.

- One spawn of 4 gloo ranks (`ranks`) runs tests/torch_dist_ranks.
  merge_worker: u64 and u32, X^N - 1 and X^N + 1, sp = 2 (on 2 x 2) and
  4 (on 1 x 4), rings 2^12-2^13, batch 4; forward, inverse, and inverse
  without n^-1, each checked in the rank against the engine route and
  the round trip, then here against the JAX package's golden NTTCPU
  (forward, and the inverse at batch 4, which the JAX round never
  asserted: VERDICT r5 weak 5), the single-chip ntt_lanes / intt_lanes,
  and for two cells against the JAX package's single-chip XLA engine.
- The tail plans: MergePlan.from_eval at 2^12 tails of a 2^14 ring and
  LargePlan.from_eval at logn 12 (A = 8), against the coset transform cut
  from the full network's tables on the engine.
- K7': its plain version against the JAX package's col_phase_local in
  Pallas interpret mode (batch 2, A = 8, B = 256, tile 128, sp = 2, both
  shards, both directions), and its CUDA entries through the g++ host
  emulation of csrc/merge_u64_large.cu; the wrapper's contract.
"""

import os

import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops.limb import from_numpy_u64, signed
from gpuntt_tpu_torch.ops.merge_ntt import MergePlan, merge_intt_lanes, merge_ntt_lanes
from gpuntt_tpu_torch.parallel.dryrun import collective_bytes, run_ranks
from gpuntt_tpu_torch.parallel.merge_dist import _shard_twists, _sliced_tail, merge_dist_tails

import torch_dist_ranks as R
from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

POLYS = {"minus": "X_N_minus", "plus": "X_N_plus"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_merge"))
    run_ranks(R.merge_worker, 4, "cpu", out)
    return lambda key: np.load(os.path.join(out, key + ".npy"))


def _params(pkg, cell):
    """The cell's merge parameters in the JAX package (jg) or the port (tg)."""
    dtype, poly, dp, sp, logn = cell
    return pkg.NTTParameters(logn, getattr(pkg.ReductionPolynomial, POLYS[poly]),
                             dtype=R.DTYPES[dtype])


@pytest.mark.parametrize("cell", R.MERGE, ids=lambda c: R.name(*c))
def test_dist_merge_matches_golden_and_single_chip(ranks, cell):
    """Forward and inverse against gpuntt_tpu.NTTCPU row by row (batch 4),
    all three against the single-chip ntt_lanes / intt_lanes (the
    unscaled inverse against intt_lanes' result times n)."""
    dt = R.DTYPES[cell[0]]
    jp, tp = _params(jg, cell), _params(tg, cell)
    gen = jg.NTTCPU(jp)
    x = R.inputs(jp.logn, [jp.modulus.value], (R.BATCH, jp.n))
    s = R.inputs(jp.logn + 1, [jp.modulus.value], (R.BATCH, jp.n))
    fwd, inv, raw = (ranks(R.name(k, *cell)) for k in ("fwd", "inv", "raw"))
    np.testing.assert_array_equal(fwd.astype(dt), gen.ntt(x.astype(dt)))
    np.testing.assert_array_equal(inv.astype(dt), gen.intt(s.astype(dt)))
    plan = tg.MergePlan.from_params(tp, device="cpu")
    lanes = lambda a: torch.from_numpy(a.view(np.int64))  # noqa: E731
    assert torch.equal(lanes(fwd), tg.ntt_lanes(lanes(x), plan))
    assert torch.equal(lanes(inv), tg.intt_lanes(lanes(s), plan))
    scaled = plan.ops().mulc(lanes(raw), plan.n_inv, signed(plan.n_inv_shoup))
    assert torch.equal(scaled, lanes(inv))


@pytest.mark.parametrize("cell", [("u64", "plus", 1, 4, 13), ("u32", "minus", 2, 2, 12)],
                         ids=lambda c: R.name(*c))
def test_dist_merge_matches_jax_engine(ranks, cell):
    """Two cells against the JAX package's single-chip merge engine (XLA),
    which its dist merge equals (tests/test_merge_dist.py)."""
    import jax

    from gpuntt_tpu.ops import merge_ntt as jm

    jp = _params(jg, cell)
    plan = jm.MergePlan.from_params(jp)
    is64 = cell[0] == "u64"
    x = R.inputs(jp.logn, [jp.modulus.value], (R.BATCH, jp.n)).astype(R.DTYPES[cell[0]])
    s = R.inputs(jp.logn + 1, [jp.modulus.value], (R.BATCH, jp.n)).astype(R.DTYPES[cell[0]])
    fwd = jm.from_lanes(jax.jit(lambda v: jm.merge_ntt_lanes(v, plan))(jm.to_lanes(x, is64)),
                        is64)
    inv = jm.from_lanes(jax.jit(lambda v: jm.merge_intt_lanes(v, plan))(jm.to_lanes(s, is64)),
                        is64)
    np.testing.assert_array_equal(ranks(R.name("fwd", *cell)).astype(x.dtype), fwd)
    np.testing.assert_array_equal(ranks(R.name("inv", *cell)).astype(x.dtype), inv)


def test_collective_bytes_are_counted(ranks):
    """collective_bytes' count equals what each rank handed batch_isend_irecv
    in one dist_merge_ntt (u64 2^13, batch 4, over sp = 4: two stages)."""
    for r in range(4):
        assert int(ranks(f"bytes_merge_rank{r}")) == collective_bytes(
            "merge", 13, 4, batch=R.BATCH) == 2 * 8 * R.BATCH * (1 << 11)


# ----------------------------------------------------------- the tail plans


@pytest.mark.parametrize("poly", ["minus", "plus"])
def test_from_eval_tails_are_the_coset_transform(poly):
    """At logn 14 over sp = 4, every rank's from_eval tail (2^12, on K1/K2's
    plain versions) holds the table entries lo + r m' + g' of the full
    network in heap order, and transforms as the tail cut from the full
    tables does on the engine, in both directions; rank 0 of X^N - 1 is
    the plain Omega transform."""
    p = tg.NTTParameters(14, getattr(tg.ReductionPolynomial, POLYS[poly]), np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = from_numpy_u64(R.inputs(3, [plan.q], (2, 1 << 12)))
    for r in range(4):
        tail, cut = merge_dist_tails(plan, 4, r), _sliced_tail(plan, 4, r)
        assert tail.genuine_root and not cut.genuine_root and tail.twist is not None
        assert torch.equal(tail.fwd_table[1:], cut.fwd_table[1:])
        assert torch.equal(tail.inv_table[1:], cut.inv_table[1:])
        assert torch.equal(tg.ntt_lanes(x, tail), merge_ntt_lanes(x, cut))
        assert torch.equal(tg.intt_lanes(x, tail), merge_intt_lanes(x, cut))
        assert merge_dist_tails(plan, 4, r) is tail  # cached
    if poly == "minus":
        omega, iomega, _, _ = _shard_twists(plan, 4, 0)
        plain = tg.MergePlan.from_arrays(plan.q, 12, tg.ReductionPolynomial.X_N_minus, omega,
                                         iomega, 1, None, None, device="cpu").with_tables()
        assert torch.equal(tg.ntt_lanes(x, merge_dist_tails(plan, 4, 0)),
                           tg.ntt_lanes(x, plain))


@pytest.mark.parametrize("poly", ["minus", "plus"])
def test_large_from_eval_is_the_coset_transform(poly):
    """LargePlan.from_eval at logn 12 with A = 8 (K7 and K8's plain
    versions: the twist in the column plan and the W factors) against the
    tail cut from a 2^14 ring's tables over sp = 4, for every rank."""
    p = tg.NTTParameters(14, getattr(tg.ReductionPolynomial, POLYS[poly]), np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    x = from_numpy_u64(R.inputs(4, [plan.q], (2, 1 << 12)))
    for r in range(4):
        lp = hml.LargePlan.from_eval(plan.q, 12, *_shard_twists(plan, 4, r), 1, a_col=8,
                                     device="cpu")
        cut = _sliced_tail(plan, 4, r)
        assert lp.col.twist is not None and lp.row_kernel == "K8"
        f = hml.merge_u64_large_plain(x, lp)
        assert torch.equal(f, merge_ntt_lanes(x, cut))
        assert torch.equal(hml.merge_u64_large_plain(f, lp, inverse=True),
                           merge_intt_lanes(f, cut))


def test_from_eval_refuses_and_keeps_genuine_root_strict():
    q = tg.NTTParameters(12, tg.ReductionPolynomial.X_N_plus, np.uint64).modulus.value
    with pytest.raises(ValueError):
        MergePlan.from_eval(q, 12, 3, pow(3, q - 2, q), 1, 1, 1, device="cpu")
    caller = tg.MergePlan.from_arrays(q, 12, tg.ReductionPolynomial.X_N_plus, 3,
                                      pow(3, q - 2, q), 1, np.arange(4096, dtype=np.uint64),
                                      np.arange(4096, dtype=np.uint64), device="cpu")
    assert not caller.genuine_root


# ------------------------------------------------------------------- K7'


def _colmat_pair():
    """The port's and the JAX package's colmat of a 2^11 ring, A = 8,
    B = 256, tile 128, n_inv = B^-1 (the dist 4-step's)."""
    from gpuntt_tpu.ops.pallas_mxu import plan_to_device
    from gpuntt_tpu.ops.pallas_mxu_large import MXULargePlan

    q = tg.find_ntt_primes(59, 11, 1)[0]
    om = tg.ntt_root_pair(q, 11)[0]
    spec = (q, 11, om, pow(om, q - 2, q))
    ninv = pow(256, q - 2, q)
    jp = plan_to_device(MXULargePlan.from_spec(*spec, xnp=False, n_inv=ninv, a_col=8,
                                               tile=128, col_only=True))
    tp = hml.LargePlan.from_spec(*spec, False, ninv, a_col=8, tile=128, col_only=True,
                                 device="cpu")
    return q, jp, tp


def test_k7_local_plain_matches_pallas_interpret():
    """col_phase_local's plain version against the JAX package's
    col_phase_local in interpret mode on both shards of sp = 2, both
    directions, the shard's slice of the per-tile W scale columns given
    as the JAX callers give it (the JAX forward leaves residues below 3q:
    compared mod q)."""
    from gpuntt_tpu.ops.limb import u64_from_numpy, u64_to_numpy
    from gpuntt_tpu.ops.pallas_mxu_large import col_phase_local

    q, jp, tp = _colmat_pair()
    x = R.inputs(11, [q], (2, 8, 256))
    for inverse in (False, True):
        ws = jp.ws_inv if inverse else jp.ws_fwd
        for sh in range(2):
            xs = np.ascontiguousarray(x[:, :, sh * 128:(sh + 1) * 128])
            want = u64_to_numpy(col_phase_local(u64_from_numpy(xs), jp,
                                                tuple(a[sh:sh + 1] for a in ws),
                                                inverse=inverse, interpret=True)) % np.uint64(q)
            got = hml.col_phase_local(from_numpy_u64(xs), tp, sh, 2, inverse)
            np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_k7_local_cuda_entries_emulated(tmp_path_factory):
    """merge_u64_large_colfwd_local / _colinv_local of csrc/merge_u64_large.cu,
    compiled by g++ through the host emulation, on every shard of sp = 1,
    2 and 4 of a (2, 32, 512) ring, any u64 word: equal to the plain
    version; a bad shard or a width below a tile is refused."""
    lib = _emulate(tmp_path_factory, "merge_u64_large")
    p = tg.NTTParameters4Step(14, tg.ReductionPolynomial.X_N_minus, np.uint64)
    q = p.modulus.value
    lp = hml.LargePlan.from_spec(q, 14, p.root_of_unity, p.inverse_root_of_unity, False,
                                 pow(512, q - 2, q), a_col=32, tile=128, col_only=True,
                                 device="cpu")
    rng = np.random.default_rng(9)
    x = from_numpy_u64(rng.integers(0, 1 << 64, size=(2, 32, 512), dtype=np.uint64,
                                    endpoint=False))
    col = lp.col
    for inverse in (False, True):
        tabs = ((col.inv_table, col.inv_shoup, lp.wt_inv, lp.wt_inv_shoup, lp.ws_inv,
                 lp.ws_inv_shoup) if inverse else
                (col.fwd_table, col.fwd_shoup, lp.wt_fwd, lp.wt_fwd_shoup, lp.ws_fwd,
                 lp.ws_fwd_shoup))
        scale = (col.n_inv, col.n_inv_shoup) if inverse else ()
        entry = getattr(lib, f"merge_u64_large_col{'inv' if inverse else 'fwd'}_local")

        def run(xs, shard, log_b):
            y = torch.empty_like(xs)
            rc = entry(0, xs.data_ptr(), y.data_ptr(), xs.shape[0], 5, log_b, shard,
                       *(t.data_ptr() for t in tabs), 7, q, (1 << 64) // q, *scale, 0, None)
            return rc, y

        for sp in (1, 2, 4):
            bl = 512 // sp
            for sh in range(sp):
                xs = x[:, :, sh * bl:(sh + 1) * bl].contiguous()
                rc, y = run(xs, sh, bl.bit_length() - 1)
                assert rc == 0
                assert torch.equal(y, hml.col_phase_local_plain(xs, lp, sh, sp, inverse))
        assert run(x[:, :, :64].contiguous(), 0, 6)[0] == 1  # 64 columns < a tile
        assert run(x, -1, 9)[0] == 1
    assert "merge_u64_large_colfwd_local" in _build._ENTRIES["merge_u64_large"]


def test_k7_local_wrapper_contract():
    """On a CPU tensor the wrapper runs the plain version and counts it;
    it refuses a width that is not B / sp, a width below a whole tile, a
    shard out of range, a non-contiguous or 2-D tensor."""
    q, _, tp = _colmat_pair()
    x = from_numpy_u64(R.inputs(2, [q], (2, 8, 256)))
    tracing.reset()
    y = hml.col_phase_local(x[:, :, :128].contiguous(), tp, 1, 2, False)
    assert (hml.COLFWD_LOCAL.plain_calls, hml.COLFWD_LOCAL.launches) == (1, 0)
    assert torch.equal(y, hml.col_phase_local_plain(x[:, :, :128], tp, 1, 2, False))
    for args in ((x, 0, 2), (x[:, :, :64].contiguous(), 0, 4), (x[:, :, :128].contiguous(), 2, 2),
                 (x[:, :, :128], 0, 2), (x.reshape(2, -1), 0, 1)):
        with pytest.raises(tg.NTTDispatchError):
            hml.col_phase_local(args[0], tp, args[1], args[2], False)


def test_k7_local_is_k7_at_sp_one():
    """At sp = 1, K7' on the whole ring is K7 (colfwd_plain / colinv_plain)."""
    q, _, tp = _colmat_pair()
    x = from_numpy_u64(R.inputs(1, [q], (2, 8 * 256)))
    for inverse, k7 in ((False, hml.colfwd_plain), (True, hml.colinv_plain)):
        got = hml.col_phase_local(x.view(2, 8, 256), tp, 0, 1, inverse)
        assert torch.equal(got.reshape(2, -1), k7(x, tp))


def test_cross_stage_twiddles_from_the_root():
    """The cross stages' scalar twiddles, computed from the root, are the
    entries lo + g of the plan's bit-reversed tables."""
    from gpuntt_tpu_torch.parallel.merge_dist import _cross_w

    for poly in ("minus", "plus"):
        p = tg.NTTParameters(12, getattr(tg.ReductionPolynomial, POLYS[poly]), np.uint64)
        plan = tg.MergePlan.from_params(p, device="cpu")
        for s in range(3):
            for r in range(8):
                idx = ((1 << s) if plan.xnp else 0) + (r >> (3 - s))
                w, _ = _cross_w(plan, s, 3, r, False)
                wi, _ = _cross_w(plan, s, 3, r, True)
                assert w == int(plan.fwd_table[idx]) and wi == int(plan.inv_table[idx])


def test_chip_smoke_dist_phase_rehearses_on_the_cpu():
    """chip_smoke.py's distribution phase at small rings on the host: a gloo
    world of one rank, the kernels' plain versions counted in place of
    their launches; the phase's own checks (routes, counts, the
    single-chip entries, every shard of K7' at sp = 4 and 8, every tail)
    pass."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    launches, err = {}, {}
    cs.dist_phase(torch.device("cpu"), np.random.default_rng(0),
                  tracing.reset, launches, err, {}, {},
                  sizes=dict(four=20, merge=14, rns=13, poly=13, merge_tails=(8, 4)))
    assert launches == {hml.COLFWD_LOCAL.name: 1, hml.COLINV_LOCAL.name: 1}
    assert err == {hml.COLFWD_LOCAL.name: 0, hml.COLINV_LOCAL.name: 0}
