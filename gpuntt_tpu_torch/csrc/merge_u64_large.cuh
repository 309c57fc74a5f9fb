// Device arithmetic of the u64 big-ring kernels (merge_u64_large.cu).
//
// The modular primitives are merge_u64.cuh's; this header adds the
// factored twist of the column phase and K8's lazy butterflies.  Moduli
// satisfy q < 2^62.

#pragma once

#include <cstddef>
#include <cstdint>

#include "merge_u64.cuh"

namespace merge_u64 {

// x * W[a, b] mod q for the twist W[a, b] = w_a^b, factored as
// W[a, jT + t] = wt[a, t] * ws[j, a]: the (A, T) tile table times the
// per-tile scale (B / T, A), each with its Shoup companion.  Two
// canonical Shoup products, tile first, as the plain version runs them.
__device__ __forceinline__ uint64_t twist(uint64_t x, int a, int b, int logA, int logT,
                                          const uint64_t* __restrict__ wt,
                                          const uint64_t* __restrict__ wts,
                                          const uint64_t* __restrict__ ws,
                                          const uint64_t* __restrict__ wss, uint64_t q) {
  const size_t t = ((size_t)a << logT) + (b & ((1 << logT) - 1));
  const size_t j = ((size_t)(b >> logT) << logA) + a;
  return shoup_mul(shoup_mul(x, wt[t], wts[t], q), ws[j], wss[j], q);
}

// A twiddle of K8: a table entry and its Shoup companion, 16 bytes.
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

// Harvey's lazy butterflies on one modulus, for radix::network (K8).
//   ct: x, y in [0, 4q) -> x + y w, x - y w, both in [0, 4q) (mod q).
//   gs: x, y in [0, 2q) -> x + y, (x - y) w, both in [0, 2q) (mod q).
// Every value stays below 4q, which is below 2^64 only for q < 2^62: the
// bound K8's wrapper holds every caller to.
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
