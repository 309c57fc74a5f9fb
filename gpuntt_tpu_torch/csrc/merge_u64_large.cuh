// Device arithmetic of the u64 register-pass kernels: the merge kernels
// (merge_u64.cu), the big-ring kernels (merge_u64_large.cu) and the u64
// 4-step column kernels (fourstep.cu).
//
// The modular primitives are merge_u64.cuh's; this header adds the lazy
// Shoup product, the lazy butterflies of the register passes and where
// a pass reads its twiddles.  Moduli satisfy q < 2^62.

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
// bound the wrappers of K1-K3, K7-K9 and K12-K14 hold every caller to.
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

// Twiddles of a register pass (radix::network's Tw): a table and its
// Shoup companion in device memory, or a block's interleaved copy in
// shared memory.
struct GlobalTw {
  const uint64_t* tw;
  const uint64_t* tws;
  __device__ __forceinline__ Twiddle operator()(int i) const {
    return Twiddle{__ldg(tw + i), __ldg(tws + i)};
  }
};
struct SharedTw {
  const Twiddle* t;
  __device__ __forceinline__ Twiddle operator()(int i) const { return t[i]; }
};

// Whether a 16-byte access at p is aligned: the kernels move an item's
// adjacent words 16 bytes at a time only where it is (a caller may hand
// them a view that starts at an odd word).
__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

}  // namespace merge_u64
