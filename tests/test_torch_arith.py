"""The port's lane arithmetic against gpuntt_tpu.ops.barrett (CPU, exact).

Port: int64 tensors holding u64 bit patterns (u32 values for the 32-bit
twins).  JAX: (hi, lo) uint32 pairs.  Operands are random words plus
edge words (0, 1, q - 1, q, 2q - 1, 2^63 - 1, 2^63, 2^64 - 1, ...), for
the u64 pool prime, a 62-bit q in [2^61, 2^62) and a 46-bit q, and for
the u32 pool prime and a 30-bit q.  Every function must agree bit for
bit on every operand, edge words included.
"""

import numpy as np
import pytest
import torch

from gpuntt_tpu.arith.host import find_ntt_primes
from gpuntt_tpu.arith.modulus import Modulus
from gpuntt_tpu.ops import barrett as jb
from gpuntt_tpu.ops.limb import u64_from_numpy, u64_to_numpy
from gpuntt_tpu_torch.ops import barrett as tb
from gpuntt_tpu_torch.ops import limb

torch.set_num_threads(2)

Q64 = [576460756061519873, find_ntt_primes(62, 14, 1)[0], find_ntt_primes(46, 14, 1)[0]]
Q32 = [469762049, find_ntt_primes(30, 10, 1)[0]]
M64 = (1 << 64) - 1


def _words64(q, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, 2, q - 2, q - 1, q, q + 1, 2 * q - 1, 2 * q, 3 * q, 4 * q - 1,
            (1 << 62) - 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64 - q, M64 - 1, M64]
    rand = rng.integers(0, 1 << 64, size=230, dtype=np.uint64, endpoint=False)
    canon = rng.integers(0, q, size=256, dtype=np.uint64)
    return np.concatenate([np.array(edge, dtype=np.uint64), rand, canon])


def _words32(q, seed):
    rng = np.random.default_rng(seed)
    edge = [0, 1, q - 1, q, 2 * q - 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    rand = rng.integers(0, 1 << 32, size=120, dtype=np.uint64)
    canon = rng.integers(0, q, size=128, dtype=np.uint64)
    return np.concatenate([np.array(edge, dtype=np.uint64), rand, canon]).astype(np.uint32)


def _t64(x):
    return limb.from_numpy_u64(x)


def _j64(x):
    return u64_from_numpy(x)


def _eq64(port, jax_pair):
    np.testing.assert_array_equal(limb.to_numpy_u64(port), u64_to_numpy(jax_pair))


def _eq32(port, jax_arr):
    got = (port & limb.M32).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jax_arr).view(np.uint32))


@pytest.mark.parametrize("q", Q64)
@pytest.mark.parametrize("fn", ["modadd64", "modsub64", "barrett_mul64"])
def test_binary64(fn, q):
    a = _words64(q, 1)
    b = np.roll(_words64(q, 2), 7)
    m = Modulus(q, bits=64)
    if fn == "barrett_mul64":
        _eq64(tb.barrett_mul64(_t64(a), _t64(b), q, m.bit, m.mu),
              jb.barrett_mul64(_j64(a), _j64(b), q, m.bit, m.mu))
    else:
        _eq64(getattr(tb, fn)(_t64(a), _t64(b), q),
              getattr(jb, fn)(_j64(a), _j64(b), jb.u64_const(q)))


@pytest.mark.parametrize("q", Q64)
@pytest.mark.parametrize("lazy", [False, True])
def test_shoup_mul64(lazy, q):
    x = _words64(q, 3)
    w = np.random.default_rng(4).integers(0, q, size=x.size, dtype=np.uint64)
    w[:3] = [0, 1, q - 1]
    ws = tb.shoup_companion(w, q, 64)
    np.testing.assert_array_equal(ws, jb.shoup_companion(w, q, 64))
    tfn, jfn = ((tb.shoup_mul64_lazy, jb.shoup_mul64_lazy) if lazy
                else (tb.shoup_mul64, jb.shoup_mul64))
    _eq64(tfn(_t64(x), _t64(w), _t64(ws), q),
          jfn(_j64(x), _j64(w), _j64(ws), jb.u64_const(q)))


@pytest.mark.parametrize("q", Q64)
def test_unary64(q):
    x = _words64(q, 5)
    tx, jx, qc = _t64(x), _j64(x), jb.u64_const(q)
    _eq64(tb.reduce_signed64(tx, q), jb.reduce_signed64(jx, qc))
    _eq64(tb.centered64(tx, q), jb.centered64(jx, qc))
    for c in (q, 2 * q, 4 * q):
        _eq64(tb.cond_sub64(tx, c), jb.cond_sub64(jx, jb.u64_const(c)))
    m = Modulus(q, bits=64)
    _eq64(tb.reduce_forced64(tx, q), jb.reduce_forced64(jx, q, m.bit, m.mu))
    assert (limb.to_numpy_u64(tb.reduce_forced64(tx, q)) == x % np.uint64(q)).all()


@pytest.mark.parametrize("q", Q32)
def test_arith32(q):
    import jax.numpy as jnp

    a = _words32(q, 6)
    b = np.roll(_words32(q, 7), 5)
    ta, tb_ = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    ja, jbb = jnp.asarray(a), jnp.asarray(b)
    m = Modulus(q, bits=32)
    _eq32(tb.modadd32(ta, tb_, q), jb.modadd32(ja, jbb, q))
    _eq32(tb.modsub32(ta, tb_, q), jb.modsub32(ja, jbb, q))
    _eq32(tb.barrett_mul32(ta, tb_, q, m.bit, m.mu), jb.barrett_mul32(ja, jbb, q, m.bit, m.mu))
    w = np.random.default_rng(8).integers(0, q, size=a.size, dtype=np.uint64).astype(np.uint32)
    ws = tb.shoup_companion(w, q, 32)
    np.testing.assert_array_equal(ws, jb.shoup_companion(w, q, 32))
    tw, tws = (torch.from_numpy(v.astype(np.int64)) for v in (w, ws))
    _eq32(tb.shoup_mul32(ta, tw, tws, q), jb.shoup_mul32(ja, jnp.asarray(w), jnp.asarray(ws), q))
    _eq32(tb.reduce_signed32(ta, q), jb.reduce_signed32(ja.view(jnp.int32), q))
    _eq32(tb.centered32(ta, q), jb.centered32(ja, q))


@pytest.mark.parametrize("q", Q32 + [find_ntt_primes(20, 14, 1)[0]])
def test_arith32_lazy_and_forced(q):
    """The pieces of the u32 kernels' reduce-on-load and butterflies:
    the lazy Shoup product on ANY u32 word, one conditional subtract,
    and x mod q for any word."""
    import jax.numpy as jnp

    a = _words32(q, 10)
    ta, ja = torch.from_numpy(a.astype(np.int64)), jnp.asarray(a)
    w = np.random.default_rng(11).integers(0, q, size=a.size, dtype=np.uint64).astype(np.uint32)
    w[:3] = [0, 1, q - 1]
    ws = tb.shoup_companion(w, q, 32)
    tw, tws = (torch.from_numpy(v.astype(np.int64)) for v in (w, ws))
    lazy = tb.shoup_mul32_lazy(ta, tw, tws, q)
    _eq32(lazy, jb.shoup_mul32_lazy(ja, jnp.asarray(w), jnp.asarray(ws), q))
    assert int(lazy.max()) < 2 * q
    for c in (q, 2 * q):
        _eq32(tb.cond_sub32(ta, c), jb.cond_sub32(ja, c))
    m = Modulus(q, bits=32)
    _eq32(tb.reduce_forced32(ta, q), jb.reduce_forced32(ja, q, m.bit, m.mu))
    assert (tb.reduce_forced32(ta, q).numpy() == a.astype(np.int64) % q).all()
    # only the low word of a lane is read
    assert torch.equal(tb.reduce_forced32(ta + (5 << 32), q), tb.reduce_forced32(ta, q))


def test_limb_primitives_against_python_ints():
    rng = np.random.default_rng(9)
    a = np.concatenate([np.array([0, 1, (1 << 63) - 1, 1 << 63, M64], dtype=np.uint64),
                        rng.integers(0, 1 << 64, size=200, dtype=np.uint64, endpoint=False)])
    b = np.roll(a, 3)
    ta, tb_ = _t64(a), _t64(b)
    hi = limb.to_numpy_u64(limb.mulhi(ta, tb_))
    lo = limb.to_numpy_u64(ta * tb_)
    approx = limb.to_numpy_u64(limb.mulhi_approx(ta, tb_))
    lt = limb.ult(ta, tb_).numpy()
    ge = limb.uge(ta, tb_).numpy()
    for i in range(a.size):
        x, y = int(a[i]), int(b[i])
        assert int(hi[i]) == (x * y) >> 64 and int(lo[i]) == (x * y) & M64
        assert int(hi[i]) - int(approx[i]) in (0, 1)
        assert bool(lt[i]) == (x < y) and bool(ge[i]) == (x >= y)
    for s in (0, 1, 31, 32, 63):
        got = limb.to_numpy_u64(limb.srl(ta, s))
        assert all(int(g) == int(v) >> s for g, v in zip(got, a))
    for s in (0, 5, 63, 64, 70, 127):
        got = limb.to_numpy_u64(limb.shr128_lo64(tb_, ta, s))
        want = [(((int(h) << 64) | int(v)) >> s) & M64 for h, v in zip(b, a)]
        assert [int(g) for g in got] == want
    assert limb.signed(M64) == -1 and limb.signed(1 << 63) == -(1 << 63)
    assert limb.signed(5) == 5
