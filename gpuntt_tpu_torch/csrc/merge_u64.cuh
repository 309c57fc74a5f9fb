// Exact u64 modular arithmetic for the merge NTT kernels (device side).
//
// Each function computes what its namesake in ops/barrett.py computes,
// on the operands the kernels give it.  Moduli satisfy q < 2^62, the
// reference's documented Barrett domain (modular_arith.cuh:66-67).

#pragma once

#include <cstdint>

namespace merge_u64 {

// (a + b) mod q for a, b < q: a + b < 2q < 2^63, no wrap.
__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

// (a - b) mod q for a, b < q: a + q - b < 2q.
__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t d = a + q - b;
  return d >= q ? d - q : d;
}

// x * w mod q with ws = floor(w * 2^64 / q), w < q: for any x the
// quotient estimate undershoots by at most 1, so r < 2q and one
// conditional subtract canonicalises (Shoup).
__device__ __forceinline__ uint64_t shoup_mul(uint64_t x, uint64_t w, uint64_t ws,
                                              uint64_t q) {
  const uint64_t r = x * w - __umul64hi(x, ws) * q;
  return r >= q ? r - q : r;
}

// x mod q for ANY u64 x, with one_s = floor(2^64 / q): Barrett by one,
// r < 2q as above (barrett.reduce_forced64).
__device__ __forceinline__ uint64_t reduce_any(uint64_t x, uint64_t q, uint64_t one_s) {
  const uint64_t r = x - __umul64hi(x, one_s) * q;
  return r >= q ? r - q : r;
}

// (a * b) mod q with the reference's Barrett schedule: bit = bit length
// of q, mu = floor(2^(2 bit + 1) / q), shifts bit - 2 and bit + 3
// (modular_arith.cuh:328-338, barrett.barrett_mul64).
__device__ __forceinline__ uint64_t barrett_mul(uint64_t a, uint64_t b, uint64_t q,
                                                int bit, uint64_t mu) {
  const unsigned __int128 z = (unsigned __int128)a * b;
  const uint64_t w = (uint64_t)(z >> (bit - 2));
  const uint64_t w2 = (uint64_t)(((unsigned __int128)w * mu) >> (bit + 3));
  const uint64_t r = (uint64_t)z - w2 * q;
  return r >= q ? r - q : r;
}

}  // namespace merge_u64
