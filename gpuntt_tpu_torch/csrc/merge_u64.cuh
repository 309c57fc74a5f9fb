// Exact u64 modular arithmetic for the merge NTT kernels (device side),
// the column stage loops that merge_u64.cu and merge_u64_large.cu
// share, and where a block finds the constants of its ring.
//
// Each arithmetic function computes what its namesake in ops/barrett.py
// computes, on the operands the kernels give it.  Moduli satisfy
// q < 2^62, the reference's documented Barrett domain
// (modular_arith.cuh:66-67).

#pragma once

#include <cstddef>
#include <cstdint>

namespace merge_u64 {

// The constants a block transforms its ring with: the transform's
// bit-reversed table and its Shoup companion, a factored twist's tile
// and scale tables with theirs (the column kernels; null elsewhere), and
// the modulus's numbers (n_inv is whatever scaling the kernel applies
// last; bit and mu are the Barrett constants of the fused product).
struct Ring {
  const uint64_t* tw;
  const uint64_t* tws;
  const uint64_t* wt;
  const uint64_t* wts;
  const uint64_t* ws;
  const uint64_t* wss;
  uint64_t q, one_s, n_inv, n_inv_s, mu;
  int bit;
};

// Every kernel is a template over where its rings' constants come from;
// `at(i)` gives those of ring i of the batch.  One modulus for the whole
// batch: the launch's own arguments, the same for every ring.
struct OneModulus {
  Ring r;
  __device__ __forceinline__ Ring at(size_t) const { return r; }
};

inline OneModulus one_modulus(const uint64_t* tw, const uint64_t* tws, uint64_t q,
                              uint64_t one_s, uint64_t n_inv = 0, uint64_t n_inv_s = 0,
                              int bit = 0, uint64_t mu = 0) {
  return OneModulus{Ring{tw, tws, nullptr, nullptr, nullptr, nullptr, q, one_s, n_inv,
                         n_inv_s, mu, bit}};
}

// RNS (the JAX package's stacked kernels, pallas_mxu_rns.py): ring i uses
// modulus m = mod_idx[i >> shift], so a schedule of one entry per
// polynomial serves its 2^shift rows.  `r` holds modulus 0's tables, the
// starts of the stacked (mod_count, len) tables, whose moduli lie tw_len,
// wt_len and ws_len entries apart, and `consts` the (mod_count, 6) words
// q, one_s, n_inv, n_inv_s, bit, mu.  Every thread of a block reads the
// same words: one broadcast load each, once per block.
struct Stacked {
  const int* mod_idx;
  int shift;
  Ring r;
  long long tw_len, wt_len, ws_len;
  const uint64_t* consts;
  __device__ __forceinline__ Ring at(size_t i) const {
    const long long m = mod_idx[i >> shift];
    const uint64_t* c = consts + 6 * m;
    Ring o = r;
    o.tw += m * tw_len;
    o.tws += m * tw_len;
    o.wt += m * wt_len;
    o.wts += m * wt_len;
    o.ws += m * ws_len;
    o.wss += m * ws_len;
    o.q = c[0];
    o.one_s = c[1];
    o.n_inv = c[2];
    o.n_inv_s = c[3];
    o.bit = (int)c[4];
    o.mu = c[5];
    return o;
  }
};

// A Stacked schedule over stacked tables of tw_len entries (wt, ws none).
inline Stacked stacked(const int* mod_idx, int shift, const uint64_t* tw, const uint64_t* tws,
                       long long tw_len, const uint64_t* consts) {
  return Stacked{mod_idx, shift,
                 Ring{tw, tws, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 0, 0},
                 tw_len, 0, 0, consts};
}

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

// Cooley-Tukey stages 0 .. logA-1 of an A-point merge network down the
// C = 2^logC columns of an (A, C) tile in shared memory, kT threads
// striding over the butterflies; stage l, group i reads table entry
// (X^N + 1 ? 2^l : 0) + i.  Inlined, so that a constant logC folds.
template <int kT>
__device__ __forceinline__ void ct_cols(uint64_t* s, int logA, int logC, const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint64_t q, int xnp) {
  const int work = 1 << (logA - 1 + logC);
  for (int l = 0; l < logA; ++l) {
    const int logt = logA - 1 - l;
    for (int k = threadIdx.x; k < work; k += kT) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int idx = xnp ? (1 << l) + i : i;
      const uint64_t u = s[p0];
      const uint64_t v = shoup_mul(s[p1], tw[idx], tws[idx], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages logA-1 .. 0 down the columns, no scaling.
template <int kT>
__device__ __forceinline__ void gs_cols(uint64_t* s, int logA, int logC, const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint64_t q, int xnp) {
  const int work = 1 << (logA - 1 + logC);
  for (int l = logA - 1; l >= 0; --l) {
    const int logt = logA - 1 - l;
    for (int k = threadIdx.x; k < work; k += kT) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int idx = xnp ? (1 << l) + i : i;
      const uint64_t u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), tw[idx], tws[idx], q);
    }
    __syncthreads();
  }
}

}  // namespace merge_u64
