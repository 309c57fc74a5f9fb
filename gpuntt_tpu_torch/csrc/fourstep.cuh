// Device side of the 4-step column kernels (fourstep.cu): the column
// stage loops over a padded tile, for either word size, and the u32 twin
// of merge_u64_large.cuh's factored twist.
//
// The arithmetic is merge_u64.cuh's (q < 2^62) and merge_u32.cuh's
// (q < 2^30); the loops call it unqualified, so the word type W
// (uint64_t or uint32_t) picks the overload.

#pragma once

#include <cstddef>
#include <cstdint>

#include "merge_u32.cuh"
#include "merge_u64_large.cuh"

namespace merge_u32 {

// x * W[a, b] mod q for the factored twist W[a, jT + t] = wt[a, t] * ws[j, a]
// (merge_u64::twist on u32 values; the tables hold int64 words).
__device__ __forceinline__ uint32_t twist(uint32_t x, int a, int b, int logA, int logT,
                                          const uint64_t* __restrict__ wt,
                                          const uint64_t* __restrict__ wts,
                                          const uint64_t* __restrict__ ws,
                                          const uint64_t* __restrict__ wss, uint32_t q) {
  const size_t t = ((size_t)a << logT) + (b & ((1 << logT) - 1));
  const size_t j = ((size_t)(b >> logT) << logA) + a;
  return shoup_mul(shoup_mul(x, (uint32_t)wt[t], (uint32_t)wts[t], q), (uint32_t)ws[j],
                   (uint32_t)wss[j], q);
}

}  // namespace merge_u32

namespace fourstep {

using merge_u32::add_mod;
using merge_u32::reduce_any;
using merge_u32::shoup_mul;
using merge_u32::sub_mod;
using merge_u32::twist;
using merge_u64::add_mod;
using merge_u64::OneModulus;
using merge_u64::reduce_any;
using merge_u64::Ring;
using merge_u64::Stacked;
using merge_u64::shoup_mul;
using merge_u64::sub_mod;
using merge_u64::twist;

// Cooley-Tukey stages 0 .. log1-1 of the n1-point NTT down the 2^logC
// columns of an (n1, 2^logC) tile whose rows lie `pitch` words apart, kT
// threads striding over the butterflies.  The 4-step's small tables are
// cyclic for either polynomial: stage l, group i reads table entry i.
template <int kT, class W>
__device__ __forceinline__ void ct_tile(W* s, int log1, int logC, int pitch,
                                        const uint64_t* __restrict__ tw,
                                        const uint64_t* __restrict__ tws, W q) {
  const int work = 1 << (log1 - 1 + logC);
  for (int l = 0; l < log1; ++l) {
    const int logt = log1 - 1 - l;
    for (int k = threadIdx.x; k < work; k += kT) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = ((i << (logt + 1)) + r) * pitch + c;
      const int p1 = p0 + (pitch << logt);
      const W u = s[p0];
      const W v = shoup_mul(s[p1], (W)tw[i], (W)tws[i], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages log1-1 .. 0 down the columns, no scaling.
template <int kT, class W>
__device__ __forceinline__ void gs_tile(W* s, int log1, int logC, int pitch,
                                        const uint64_t* __restrict__ tw,
                                        const uint64_t* __restrict__ tws, W q) {
  const int work = 1 << (log1 - 1 + logC);
  for (int l = log1 - 1; l >= 0; --l) {
    const int logt = log1 - 1 - l;
    for (int k = threadIdx.x; k < work; k += kT) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = ((i << (logt + 1)) + r) * pitch + c;
      const int p1 = p0 + (pitch << logt);
      const W u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), (W)tw[i], (W)tws[i], q);
    }
    __syncthreads();
  }
}

}  // namespace fourstep
