"""Plain modular polynomial arithmetic: the benchmark's reference.

Exact arithmetic modulo primes q < 2^59 on int64 tensors, in plain PyTorch
on whatever device the operands lie on, written for clarity and checked
against schoolbook products in the tests.  It imports nothing of the
program it judges and takes no table from it: every power of a root is
worked out here from (q, root).

Rows may carry different moduli: `q` is then an int64 tensor of shape
(rows, 1), one modulus a row, and every function broadcasts over it.

The product a * b mod q is a Horner sum over b's bits in chunks of three:
r <- (8 r + a c) mod q with c < 8, whose terms stay below 15 q < 2^63.
`mulmod_f64` is the same product taken through float64, the narrower
arithmetic a faster implementation might be tempted by; it is the
control that the comparison must reject.
"""

from __future__ import annotations

import torch

Q_LIMIT = 1 << 59  # 8 r + a c < 15 q stays below 2^63
_CHUNK = 3


def _q(q, x: torch.Tensor):
    """`q` as an int64 tensor on x's device, broadcastable against x's
    trailing axes (a (rows, 1) tensor gains unit axes after the first)."""
    q = torch.as_tensor(q, dtype=torch.int64, device=x.device)
    while q.dim() and q.dim() < x.dim():
        q = q.unsqueeze(-1)
    return q


def check_modulus(q) -> None:
    qs = q.flatten().tolist() if isinstance(q, torch.Tensor) else [int(q)]
    if not all(2 < v < Q_LIMIT for v in qs):
        raise ValueError(f"the reference takes moduli in (2, 2^59), got {qs}")


def addmod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    s = a + b
    q = _q(q, s)
    return torch.where(s >= q, s - q, s)


def submod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + _q(q, d), d)


def mulmod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a * b mod q, exact, for a, b in [0, q) and q < 2^59."""
    a, b = torch.broadcast_tensors(a, b)
    q = _q(q, a)
    r = None
    for shift in range(57, -1, -_CHUNK):
        t = a * ((b >> shift) & ((1 << _CHUNK) - 1))
        r = t.remainder(q) if r is None else ((r << _CHUNK) + t).remainder(q)
    return r


def mulmod_f64(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """a * b mod q with the quotient taken in float64 and one correction:
    exact only while a * b / q is exact to within one, far from it at 59
    bits.  The control of the comparison; never the reference."""
    a, b = torch.broadcast_tensors(a, b)
    q = _q(q, a)
    quot = torch.floor(a.double() * b.double() / q.double()).long()
    r = a * b - quot * q  # wraps modulo 2^64 like the products it stands for
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def powers(base, q, count: int, mul=mulmod) -> torch.Tensor:
    """(rows, count): base^0 .. base^(count-1) mod q, one row per modulus;
    `base` and `q` are (rows, 1) int64 tensors."""
    out = torch.ones_like(base)
    step = base.clone()  # base^(out's length)
    while out.shape[-1] < count:
        out = torch.cat([out, mul(out, step.expand_as(out), q)], dim=-1)
        step = mul(step, step, q)
    return out[:, :count].contiguous()


def bitrev(logn: int, device=None) -> torch.Tensor:
    """The bit reversal of 0 .. 2^logn - 1 over logn bits."""
    i = torch.arange(1 << logn, device=device)
    r = torch.zeros_like(i)
    for b in range(logn):
        r |= ((i >> b) & 1) << (logn - 1 - b)
    return r


def dft(x: torch.Tensor, q, root, mul=mulmod) -> torch.Tensor:
    """X[e] = sum_m x[m] root^(m e) mod q along the last axis of (rows, N),
    natural order in and out (iterative radix-2 on bit-reversed input);
    `q` and `root` are (rows, 1) tensors, `root` a primitive N-th root."""
    rows, n = x.shape
    logn = n.bit_length() - 1
    tw = powers(root, q, max(n // 2, 1), mul)
    q3 = q.unsqueeze(-1)
    x = x[:, bitrev(logn, x.device)]
    half = 1
    while half < n:
        w = tw[:, ::n // (2 * half)][:, None, :]  # root^(k N / 2half), k < half
        y = x.reshape(rows, n // (2 * half), 2, half)
        u, v = y[:, :, 0, :], mul(y[:, :, 1, :], w, q3)
        x = torch.stack([addmod(u, v, q3), submod(u, v, q3)], dim=2).reshape(rows, n)
        half *= 2
    return x


def inverse_dft(x: torch.Tensor, q, root, mul=mulmod) -> torch.Tensor:
    """The inverse of dft: the same sum with root^-1, times N^-1."""
    n = x.shape[-1]
    qs = [int(v) for v in q.flatten().tolist()]
    iroot = _per_row([pow(int(r), -1, m) for r, m in zip(root.flatten().tolist(), qs)], x)
    ninv = _per_row([pow(n, -1, m) for m in qs], x)
    return mul(dft(x, q, iroot, mul), ninv.expand_as(x), q)


def _per_row(values, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=x.device).reshape(-1, 1)


def polymul(a: torch.Tensor, b: torch.Tensor, q, psi, negacyclic: bool,
            mul=mulmod) -> torch.Tensor:
    """a * b modulo (q, X^N + 1) when `negacyclic`, else (q, X^N - 1), for
    (rows, N) tensors; `q` and `psi` are (rows, 1) tensors, psi a
    primitive 2N-th root of unity modulo its row's q."""
    check_modulus(q)
    rows, n = a.shape
    omega = mul(psi, psi, q)
    if not negacyclic:
        fa, fb = dft(a, q, omega, mul), dft(b, q, omega, mul)
        return inverse_dft(mul(fa, fb, q), q, omega, mul)
    tw = powers(psi, q, n, mul)
    fa, fb = dft(mul(a, tw, q), q, omega, mul), dft(mul(b, tw, q), q, omega, mul)
    c = inverse_dft(mul(fa, fb, q), q, omega, mul)
    qs = [int(v) for v in q.flatten().tolist()]
    ipsi = _per_row([pow(int(p), -1, m) for p, m in zip(psi.flatten().tolist(), qs)], a)
    return mul(c, powers(ipsi, q, n, mul), q)


def fourstep_order(n1: int, n2: int, device=None) -> torch.Tensor:
    """(n1 * n2,) indices: position k n2 + l of the 4-step layout holds the
    transform's coefficient br(k) + n1 br(l) (bit reversals over log n1
    and log n2 bits), GPU-NTT's 4-step output order before the caller's
    last transpose."""
    b1 = bitrev(n1.bit_length() - 1, device)
    b2 = bitrev(n2.bit_length() - 1, device)
    return (b1[:, None] + n1 * b2[None, :]).reshape(-1)


def fourstep_forward(y: torch.Tensor, q, root, n1: int, n2: int, mul=mulmod):
    """GPU-NTT's 4-step forward on its own layout: `y` is the (n2, n1)
    transpose of the natural coefficients, flattened; the result is the
    cyclic transform by `root` in fourstep_order."""
    check_modulus(q)
    rows = y.shape[0]
    x = y.reshape(rows, n2, n1).transpose(1, 2).reshape(rows, -1)
    return dft(x, q, root, mul)[:, fourstep_order(n1, n2, y.device)]


def fourstep_inverse(z: torch.Tensor, q, root, n1: int, n2: int, mul=mulmod):
    """GPU-NTT's 4-step inverse on its own layout: `z` holds transform
    coefficients in fourstep_order; the result is their inverse
    transform (N^-1 included), read as the (n2, n1) matrix of natural
    coefficients and transposed, flattened."""
    check_modulus(q)
    rows = z.shape[0]
    spec = torch.empty_like(z)
    spec[:, fourstep_order(n1, n2, z.device)] = z
    x = inverse_dft(spec, q, root, mul)
    return x.reshape(rows, n2, n1).transpose(1, 2).reshape(rows, -1)
