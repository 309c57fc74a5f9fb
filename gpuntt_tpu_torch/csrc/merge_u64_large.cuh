// Device arithmetic of the u64 big-ring kernels (merge_u64_large.cu)
// and the u64 4-step column kernels (fourstep.cu).
//
// The modular primitives are merge_u64.cuh's; this header adds the lazy
// Shoup product and the lazy butterflies of their register passes.
// Moduli satisfy q < 2^62.

#pragma once

#include <cstddef>
#include <cstdint>

#include "merge_u64.cuh"

namespace merge_u64 {

// A twiddle: a table entry and its Shoup companion, 16 bytes.
struct alignas(16) Twiddle {
  uint64_t w, ws;
};

// x * w mod q + e * q, e in {0, 1}, for ANY u64 x, with
// ws = floor(w * 2^64 / q), w < q: Shoup's product without its
// conditional subtract, r < 2q.
__device__ __forceinline__ uint64_t shoup_mul_lazy(uint64_t x, uint64_t w, uint64_t ws,
                                                   uint64_t q) {
  return x * w - __umul64hi(x, ws) * q;
}

// Harvey's lazy butterflies on one modulus, for radix::network.
//   ct: x, y in [0, 4q) -> x + y w, x - y w, both in [0, 4q) (mod q).
//   gs: x, y in [0, 2q) -> x + y, (x - y) w, both in [0, 2q) (mod q).
// Every value stays below 4q, which is below 2^64 only for q < 2^62: the
// bound the wrappers of K7, K8 and K9 hold every caller to.
struct Lazy64 {
  uint64_t q, q2;
  __device__ __forceinline__ void ct(uint64_t& x, uint64_t& y, const Twiddle& t) const {
    const uint64_t u = x >= q2 ? x - q2 : x;
    const uint64_t v = shoup_mul_lazy(y, t.w, t.ws, q);
    x = u + v;
    y = u - v + q2;
  }
  __device__ __forceinline__ void gs(uint64_t& x, uint64_t& y, const Twiddle& t) const {
    const uint64_t u = x, v = y, s = u + v;
    x = s >= q2 ? s - q2 : s;
    y = shoup_mul_lazy(u - v + q2, t.w, t.ws, q);
  }
};

}  // namespace merge_u64
