// Exact u32 modular arithmetic for the u32 merge NTT kernels (device side).
//
// Each function computes what its namesake in ops/barrett.py computes, on
// the operands the kernels give it.  Moduli satisfy q < 2^30 (the route's
// bound, as the JAX package's K5/K6 route): canonical sums stay < 2q and
// lazy Shoup results < 2q, both well inside the word.

#pragma once

#include <cstdint>

namespace merge_u32 {

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

}  // namespace merge_u32
