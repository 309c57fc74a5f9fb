// Device arithmetic of the u64 big-ring kernels (merge_u64_large.cu).
//
// The modular primitives are merge_u64.cuh's; this header adds the
// factored twist of the column phase.  Moduli satisfy q < 2^62.

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

}  // namespace merge_u64
