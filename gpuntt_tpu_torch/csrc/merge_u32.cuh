// Exact u32 modular arithmetic for the u32 merge NTT kernels (device
// side), and where a block finds the constants of its ring.
//
// Each arithmetic function computes what its namesake in ops/barrett.py
// computes, on the operands the kernels give it.  Moduli satisfy q < 2^30
// (the route's bound, as the JAX package's K5/K6 route): canonical sums
// stay < 2q and lazy Shoup results < 2q, both well inside the word.

#pragma once

#include <cstddef>
#include <cstdint>

namespace merge_u32 {

// The constants a block transforms its ring with: the transform's
// bit-reversed table and its Shoup companion (int64 words holding u32
// values), and the modulus's numbers: q, floor(2^32 / q), whatever
// scaling the kernel applies last (n_inv) with its Shoup companion, and
// the Barrett constants of the fused product (bit, mu).
struct Ring {
  const uint64_t* tw;
  const uint64_t* tws;
  uint32_t q, one_s, n_inv, n_inv_s, mu;
  int bit;
};

// Every kernel is a template over where its rings' constants come from;
// `at(i)` gives those of ring i of the batch.  One modulus for the whole
// batch: the launch's own arguments, the same for every ring, so a row
// block may hold any number of rings (`ring_log`: no limit).
struct OneModulus {
  Ring r;
  __device__ __forceinline__ Ring at(size_t) const { return r; }
  int ring_log() const { return 31; }
};

// RNS (the JAX package's stacked u32 kernel, pallas_mxu_rns.py:846-857):
// ring i uses modulus m = mod_idx[i >> shift], so a schedule of one entry
// per polynomial serves its 2^shift rings.  tw / tws are the starts of the
// stacked (mod_count, tw_len) tables, `consts` the (mod_count, 6) int64
// words q, floor(2^32 / q), n_inv, n_inv_s, bit, mu of ops/rns.py's
// RNSMergePlan.  A block covers rings of one modulus only (`ring_log`:
// 2^shift rings share one), and reads its constants once.
struct Stacked {
  const int* mod_idx;
  int shift;
  const uint64_t* tw;
  const uint64_t* tws;
  long long tw_len;
  const uint64_t* consts;
  __device__ __forceinline__ Ring at(size_t i) const {
    const long long m = mod_idx[i >> shift];
    const uint64_t* c = consts + 6 * m;
    return Ring{tw + m * tw_len, tws + m * tw_len, (uint32_t)c[0], (uint32_t)c[1],
                (uint32_t)c[2], (uint32_t)c[3], (uint32_t)c[5], (int)c[4]};
  }
  int ring_log() const { return shift; }
};

// x - c if x >= c else x (barrett.cond_sub32).
__device__ __forceinline__ uint32_t cond_sub(uint32_t x, uint32_t c) {
  return x >= c ? x - c : x;
}

// (a + b) mod q for a, b < q.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  return cond_sub(a + b, q);
}

// (a - b) mod q for a, b < q: a + q - b < 2q.
__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return cond_sub(a + q - b, q);
}

// x * w mod q + e * q, e in {0, 1}, for ANY u32 x, with
// ws = floor(w * 2^32 / q), w < q: the quotient estimate undershoots by at
// most 1, so r < 2q (barrett.shoup_mul32_lazy).
__device__ __forceinline__ uint32_t shoup_mul_lazy(uint32_t x, uint32_t w, uint32_t ws,
                                                   uint32_t q) {
  return x * w - __umulhi(x, ws) * q;
}

// x * w mod q, canonical (barrett.shoup_mul32).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w, uint32_t ws,
                                              uint32_t q) {
  return cond_sub(shoup_mul_lazy(x, w, ws, q), q);
}

// x mod q for ANY u32 x, with one_s = floor(2^32 / q): a lazy Shoup
// product by 1, then one subtract (barrett.reduce_forced32).
__device__ __forceinline__ uint32_t reduce_any(uint32_t x, uint32_t q, uint32_t one_s) {
  return shoup_mul(x, 1u, one_s, q);
}

// (a * b) mod q with the reference's Barrett schedule: bit = bit length
// of q, mu = floor(2^(2 bit + 1) / q) < 2^32, shifts bit - 2 and bit + 3
// (modular_arith.cuh:316-326, barrett.barrett_mul32).
__device__ __forceinline__ uint32_t barrett_mul(uint32_t a, uint32_t b, uint32_t q, int bit,
                                                uint32_t mu) {
  const uint64_t z = (uint64_t)a * b;
  const uint32_t w = (uint32_t)(z >> (bit - 2));
  const uint32_t w2 = (uint32_t)(((uint64_t)w * mu) >> (bit + 3));
  return cond_sub((uint32_t)z - w2 * q, q);
}

}  // namespace merge_u32
