// Device side of the 4-step column kernels (fourstep.cu): what their
// register passes need of the word type W (uint64_t or uint32_t).
//
// The arithmetic is merge_u64_large.cuh's (Lazy64, q < 2^62) and
// merge_u32.cuh's (Lazy, q < 2^30): lazy butterflies whose values stay
// below 4q, which fits the word only under those bounds.

#pragma once

#include <cstddef>
#include <cstdint>

#include "merge_u32.cuh"
#include "merge_u64_large.cuh"

namespace fourstep {

template <class W>
struct Word;

// u64: a twiddle is 16 bytes, an entry and its Shoup companion.
template <>
struct Word<uint64_t> {
  using Ar = merge_u64::Lazy64;
  using Tw = merge_u64::Twiddle;
  __device__ __forceinline__ static Tw twiddle(uint64_t w, uint64_t ws) { return Tw{w, ws}; }
  // x mod q + e q, e in {0, 1}, for any input word
  __device__ __forceinline__ static uint64_t reduce(uint64_t x, uint64_t q, uint64_t one_s) {
    return merge_u64::shoup_mul_lazy(x, 1, one_s, q);
  }
  // x wt ws mod q for any x: the first product lazy (below 2q), the
  // second canonical
  __device__ __forceinline__ static uint64_t twist(uint64_t x, uint64_t wt, uint64_t wts,
                                                   uint64_t ws, uint64_t wss, uint64_t q) {
    return merge_u64::shoup_mul(merge_u64::shoup_mul_lazy(x, wt, wts, q), ws, wss, q);
  }
};

// u32 (values in the low 32 bits of int64 lanes): a twiddle is one
// packed 8-byte word, the entry low and its Shoup companion high, as
// merge_u32::Lazy takes it; the tables hold int64 words.
template <>
struct Word<uint32_t> {
  using Ar = merge_u32::Lazy;
  using Tw = uint64_t;
  __device__ __forceinline__ static Tw twiddle(uint64_t w, uint64_t ws) {
    return (uint64_t)(uint32_t)w | (ws << 32);
  }
  __device__ __forceinline__ static uint32_t reduce(uint64_t x, uint32_t q, uint32_t one_s) {
    return merge_u32::shoup_mul_lazy((uint32_t)x, 1u, one_s, q);
  }
  __device__ __forceinline__ static uint32_t twist(uint32_t x, uint64_t wt, uint64_t wts,
                                                   uint64_t ws, uint64_t wss, uint32_t q) {
    return merge_u32::shoup_mul(merge_u32::shoup_mul_lazy(x, (uint32_t)wt, (uint32_t)wts, q),
                                (uint32_t)ws, (uint32_t)wss, q);
  }
};

// Twiddles: the plan's two tables in device memory (the first pass), or
// the block's copy in shared memory, in the form Word<W>::Ar takes.
template <class W>
struct GlobalTw {
  const uint64_t* tw;
  const uint64_t* tws;
  __device__ __forceinline__ typename Word<W>::Tw operator()(int i) const {
    return Word<W>::twiddle(__ldg(tw + i), __ldg(tws + i));
  }
};

template <class W>
struct SharedTw {
  const typename Word<W>::Tw* t;
  __device__ __forceinline__ typename Word<W>::Tw operator()(int i) const { return t[i]; }
};

}  // namespace fourstep
