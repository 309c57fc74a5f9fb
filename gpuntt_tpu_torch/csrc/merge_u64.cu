// Hopper kernels of the u64 merge NTT main path (sm_90a).
//
// They replace the JAX package's three Pallas kernels in
// gpuntt_tpu/ops/pallas_mxu.py:
//   merge_u64_forward         <- _fwd_kernel     (entry pallas_mxu_u64)
//   merge_u64_inverse         <- _inv_kernel     (pallas_mxu_u64, inverse=True)
//   merge_u64_polymul_inverse <- _inv_mul_kernel (pallas_mxu_polymul_inv_u64)
// and compute what those compute: the merged NTT of each (batch, N) row
// in the reference's bit-reversed output order, its inverse with the
// n^-1 scaling last, and INTT(fa o fb) with the Barrett product fused
// into the first load.  Outputs are canonical residues, bit-identical to
// ops/merge_ntt.py's engine (and so to the JAX package) for inputs
// below q; like the TPU kernels, any u64 input is first reduced mod q.
//
// The same kernels serve RNS batches (K12, ops/hopper_rns.py), replacing
// the stacked kernels of gpuntt_tpu/ops/pallas_mxu_rns.py:
//   rns_u64_forward         <- _rns_fwd_kernel (:178, entry pallas_mxu_rns_u64)
//   rns_u64_inverse         <- _rns_inv_kernel (:190)
//   rns_u64_polymul_inverse <- _rns_inv_kernel with the product fused
//                              (the JAX package leaves it unfused)
// Each kernel is a template over where a ring's constants come from
// (merge_u64.cuh): the launch's arguments for one modulus, or for RNS the
// ring's entry of the schedule, which picks its modulus's rows of the
// stacked tables and constants.  Every block lies in one ring, so it
// reads its modulus once; the TPU kernels' scalar prefetch becomes that
// one load.  The single-modulus instantiations read their constants
// from the launch's arguments, as before the template.
//
// Choice: butterflies, not digits.  The TPU kernels cut each product
// into int8 digit matmuls because the TPU has no wide multiplier.  This
// card multiplies 64 x 64 -> 128 natively (__umul64hi), so each stage is
// the reference's radix-2 butterfly with a Shoup constant product.
//
// Two phases through device memory.  A ring of N = 2^16 u64 is 512 KiB,
// more than the 227 KB of shared memory a block can hold, so the ring
// is viewed as an (A, B) matrix, element j at (j / B, j % B):
//   - the first log A stages of the merge network pair elements B * t
//     apart, i.e. run down the columns; one block takes 16 columns of
//     one ring (A x 16 words);
//   - the last log B stages pair elements within a row; one block takes
//     whole rows.  Their twiddles come from the same bit-reversed table
//     (row a, local stage l, group i reads entry (a << l) + i, offset by
//     the stage's 2^s for X^N + 1), so the TPU factorization's W matrix
//     is folded into the row stages and costs no pass of its own.
// The inverse runs the Gentleman-Sande network the other way: rows
// first, then columns, then n^-1.  Each kernel keeps its tile in 32 KiB
// of static shared memory, 256 threads, one __syncthreads per stage.
//
// Bound: at 2^16 x 128 each transform passes over the 64 MiB batch four
// times (two reads, two writes) and computes 2^15 * 16 = 2^19 Shoup
// products per ring; tensor cores, TMA and clusters are not used.  An
// RNS batch adds one modulus's tables per ring to the reads, 1 MiB at
// 2^16 for X^N + 1, which L2 (50 MB) keeps for every ladder up to ~40.
//
// Value bound: every stage keeps canonical residues (< q), so a sum is
// < 2q and u + q - v < 2q; with q < 2^62 neither reaches 2^63, and the
// Shoup and Barrett products are exact for q < 2^62 (merge_u64.cuh).
// The wide moduli q in [2^60, 2^62) need nothing more.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u64.cuh"

namespace merge_u64 {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // words of shared memory per block (32 KiB)
constexpr int kLogTile = 12;
constexpr int kCols = 16;    // columns per column-phase block
constexpr int kLogCols = 4;

// Cooley-Tukey stages logA .. logn-1 along `rows` rows of length B = 2^logB
// whose first row is row a0 of the ring.
__device__ void ct_rows(uint64_t* s, int rows, int a0, int logA, int logB,
                        const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint64_t q, int xnp) {
  const int work = rows << (logB - 1);
  for (int l = 0; l < logB; ++l) {
    const int logt = logB - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (logB - 1), bf = k & ((1 << (logB - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << logB) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const int g = ((a0 + j) << l) + i;
      const int idx = xnp ? (1 << (logA + l)) + g : g;
      const uint64_t u = s[p0];
      const uint64_t v = shoup_mul(s[p1], tw[idx], tws[idx], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages logn-1 .. logA along rows.
__device__ void gs_rows(uint64_t* s, int rows, int a0, int logA, int logB,
                        const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint64_t q, int xnp) {
  const int work = rows << (logB - 1);
  for (int l = logB - 1; l >= 0; --l) {
    const int logt = logB - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (logB - 1), bf = k & ((1 << (logB - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << logB) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const int g = ((a0 + j) << l) + i;
      const int idx = xnp ? (1 << (logA + l)) + g : g;
      const uint64_t u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), tw[idx], tws[idx], q);
    }
    __syncthreads();
  }
}

// Forward phase 1: columns.  Block = (ring, 16 columns); x -> y.
template <class F>
__global__ void __launch_bounds__(kThreads)
fwd_cols(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int logn, int logA, F fs,
         int xnp) {
  __shared__ uint64_t s[kTile];
  const int logB = logn - logA;
  const int tiles = 1 << (logB - kLogCols);
  const size_t ring = blockIdx.x >> (logB - kLogCols);
  const Ring f = fs.at(ring);
  const size_t off = (ring << logn) + ((blockIdx.x & (tiles - 1)) << kLogCols);
  const int words = kCols << logA;
  for (int e = threadIdx.x; e < words; e += kThreads)
    s[e] = reduce_any(x[off + ((size_t)(e >> kLogCols) << logB) + (e & (kCols - 1))],
                      f.q, f.one_s);
  __syncthreads();
  ct_cols<kThreads>(s, logA, kLogCols, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + ((size_t)(e >> kLogCols) << logB) + (e & (kCols - 1))] = s[e];
}

// Forward phase 2: rows, in place on y.  Block = (ring, 2^kLw / B rows):
// kLw = kLogTile, or 11 for a 2^11 ring, which one block holds whole
// (the rows of a 2^18 ring, hopper_merge_large.py).
template <int kLw, class F>
__global__ void __launch_bounds__(kThreads)
fwd_rows(uint64_t* __restrict__ y, int logn, int logA, F fs, int xnp) {
  __shared__ uint64_t s[1 << kLw];
  const int logB = logn - logA;
  const int rows = (1 << kLw) >> logB;
  const int per_ring = (1 << logA) / rows;
  const int a0 = (blockIdx.x % per_ring) * rows;
  const size_t ring = blockIdx.x / per_ring;
  const Ring f = fs.at(ring);
  uint64_t* base = y + (ring << logn) + ((size_t)a0 << logB);
  for (int e = threadIdx.x; e < (1 << kLw); e += kThreads) s[e] = base[e];
  __syncthreads();
  ct_rows(s, rows, a0, logA, logB, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < (1 << kLw); e += kThreads) base[e] = s[e];
}

// Inverse phase 1: rows.  kMul: the load is the Barrett product a o b
// (polymul); otherwise it reduces a mod q.  -> y.
template <bool kMul, int kLw, class F>
__global__ void __launch_bounds__(kThreads)
inv_rows(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
         uint64_t* __restrict__ y, int logn, int logA, F fs, int xnp) {
  __shared__ uint64_t s[1 << kLw];
  const int logB = logn - logA;
  const int rows = (1 << kLw) >> logB;
  const int per_ring = (1 << logA) / rows;
  const int a0 = (blockIdx.x % per_ring) * rows;
  const size_t ring = blockIdx.x / per_ring;
  const Ring f = fs.at(ring);
  const size_t off = (ring << logn) + ((size_t)a0 << logB);
  for (int e = threadIdx.x; e < (1 << kLw); e += kThreads)
    s[e] = kMul ? barrett_mul(a[off + e], b[off + e], f.q, f.bit, f.mu)
                : reduce_any(a[off + e], f.q, f.one_s);
  __syncthreads();
  gs_rows(s, rows, a0, logA, logB, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < (1 << kLw); e += kThreads) y[off + e] = s[e];
}

// Inverse phase 2: columns, then n^-1, in place on y.
template <class F>
__global__ void __launch_bounds__(kThreads)
inv_cols(uint64_t* __restrict__ y, int logn, int logA, F fs, int xnp) {
  __shared__ uint64_t s[kTile];
  const int logB = logn - logA;
  const int tiles = 1 << (logB - kLogCols);
  const size_t ring = blockIdx.x >> (logB - kLogCols);
  const Ring f = fs.at(ring);
  const size_t off = (ring << logn) + ((blockIdx.x & (tiles - 1)) << kLogCols);
  const int words = kCols << logA;
  for (int e = threadIdx.x; e < words; e += kThreads)
    s[e] = y[off + ((size_t)(e >> kLogCols) << logB) + (e & (kCols - 1))];
  __syncthreads();
  gs_cols<kThreads>(s, logA, kLogCols, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + ((size_t)(e >> kLogCols) << logB) + (e & (kCols - 1))] =
        shoup_mul(s[e], f.n_inv, f.n_inv_s, f.q);
}

// log2 of the words a row block holds: kTile, or the whole 2^11 ring.
int row_tile_log(int logn) { return logn < kLogTile ? logn : kLogTile; }

// Shapes the tiles cover: a column tile of A x 16 words and whole rows
// within kTile words, at least one block of rows per ring (the whole
// ring at logn 11, the smallest).
bool shape_ok(long long batch, int logn, int logA) {
  const int logB = logn - logA;
  return batch > 0 && logA >= 1 && logB >= kLogCols && (kCols << logA) <= kTile &&
         logn >= 11 && (1 << logB) <= kTile &&
         batch * ((long long)1 << (logB - kLogCols)) < (1LL << 31) &&
         batch * ((long long)1 << (logn - row_tile_log(logn))) < (1LL << 31);
}

int grid_cols(long long batch, int logn, int logA) {
  return (int)(batch << (logn - logA - kLogCols));
}

int grid_rows(long long batch, int logn) {
  return (int)(batch << (logn - row_tile_log(logn)));
}

int launch_status() {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e;
}

// Check the shape and select the card; 0 or a cudaError_t.
int begin(int device, long long batch, int logn, int logA) {
  if (!shape_ok(batch, logn, logA)) return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

// A schedule of `entries` moduli for `batch` rings, 2^shift rings each.
bool schedule_ok(long long batch, long long entries, int shift) {
  return shift >= 0 && shift < 31 && entries > 0 && (entries << shift) == batch;
}

template <class F>
int forward(const uint64_t* x, uint64_t* y, long long batch, int logn, int logA, F f,
            int xnp, cudaStream_t st) {
  fwd_cols<F><<<grid_cols(batch, logn, logA), kThreads, 0, st>>>(x, y, logn, logA, f, xnp);
  if (int rc = launch_status()) return rc;
  auto rows = logn < kLogTile ? fwd_rows<11, F> : fwd_rows<kLogTile, F>;
  rows<<<grid_rows(batch, logn), kThreads, 0, st>>>(y, logn, logA, f, xnp);
  return launch_status();
}

// kMul: INTT(a o b); otherwise INTT(a) (b unused).
template <bool kMul, class F>
int inverse(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, int logn,
            int logA, F f, int xnp, cudaStream_t st) {
  auto rows = logn < kLogTile ? inv_rows<kMul, 11, F> : inv_rows<kMul, kLogTile, F>;
  rows<<<grid_rows(batch, logn), kThreads, 0, st>>>(a, b, y, logn, logA, f, xnp);
  if (int rc = launch_status()) return rc;
  inv_cols<F><<<grid_cols(batch, logn, logA), kThreads, 0, st>>>(y, logn, logA, f, xnp);
  return launch_status();
}

// The stacked tables of an RNS schedule: 2^logn entries per modulus for
// X^N + 1, 2^(logn-1) for X^N - 1.
Stacked rns(const int* mod_idx, int shift, int logn, const uint64_t* tw, const uint64_t* tws,
            const uint64_t* consts, int xnp) {
  return stacked(mod_idx, shift, tw, tws, xnp ? 1LL << logn : 1LL << (logn - 1), consts);
}

}  // namespace
}  // namespace merge_u64

using namespace merge_u64;

// Every entry: pointers to contiguous (batch, 2^logn) u64 rows on card
// `device`, launches on `stream`, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launches (0 = none).
// The merge_u64_* entries take one modulus: its table with its Shoup
// companion and its numbers.  The rns_u64_* entries (K12) take an int32
// schedule of batch >> shift moduli (ring i uses modulus
// mod_idx[i >> shift], every entry in [0, mod_count)), the stacked
// (mod_count, table) tables and the (mod_count, 6) constants of
// ops/rns.py's RNSMergePlan.
extern "C" {

int merge_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                      int logA, const uint64_t* tw, const uint64_t* tws, uint64_t q,
                      uint64_t one_s, int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, one_modulus(tw, tws, q, one_s), xnp,
                 (cudaStream_t)stream);
}

int merge_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                      int logA, const uint64_t* tw, const uint64_t* tws, uint64_t q,
                      uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s, int xnp,
                      void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn, logA,
                        one_modulus(tw, tws, q, one_s, n_inv, n_inv_s), xnp,
                        (cudaStream_t)stream);
}

int merge_u64_polymul_inverse(int device, const uint64_t* fa, const uint64_t* fb,
                              uint64_t* y, long long batch, int logn, int logA,
                              const uint64_t* tw, const uint64_t* tws, uint64_t q, int bit,
                              uint64_t mu, uint64_t n_inv, uint64_t n_inv_s, int xnp,
                              void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<true>(fa, fb, y, batch, logn, logA,
                       one_modulus(tw, tws, q, 0, n_inv, n_inv_s, bit, mu), xnp,
                       (cudaStream_t)stream);
}

int rns_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, rns(mod_idx, shift, logn, tw, tws, consts, xnp),
                 xnp, (cudaStream_t)stream);
}

int rns_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn, logA,
                        rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                        (cudaStream_t)stream);
}

int rns_u64_polymul_inverse(int device, const uint64_t* fa, const uint64_t* fb, uint64_t* y,
                            long long batch, int logn, int logA, const int* mod_idx,
                            long long entries, int shift, const uint64_t* tw,
                            const uint64_t* tws, const uint64_t* consts, int xnp,
                            void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<true>(fa, fb, y, batch, logn, logA,
                       rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                       (cudaStream_t)stream);
}

}  // extern "C"
