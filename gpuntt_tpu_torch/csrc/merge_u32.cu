// Hopper kernels of the u32 merge NTT path (sm_90a).
//
// One family of two entries serves the u32 merged NTT at every ring size
// the route takes, logn 8-25, and with it the three Pallas kernels the
// JAX package chooses among by ring size (gpuntt_tpu/ops/dispatch.py:94-109):
//   logn <= 16  K4  pallas_merge2.py  _fwd_kernel / _inv_kernel (roll butterflies)
//   logn 17     K5  pallas_mxu32.py   _fwd_kernel32 / _inv_kernel32 (digit matmuls)
//   logn 18-25  K6  pallas_mxu32.py   _colfwd32 / _colinv32 (columns), K5 for rows
// The TPU needed three kernels for its VMEM ceilings; the function is the
// same, so one family serves all three here:
//   merge_u32_forward: the merged NTT of each (batch, 2^logn) row, in the
//                      reference's bit-reversed output order;
//   merge_u32_inverse: the Gentleman-Sande inverse, n^-1 scaling last.
// Outputs are canonical residues, bit-identical to ops/merge_ntt.py's
// engine (and so to the JAX package) for inputs below q; as in
// merge_u64.cu, any u32 input word is first reduced mod q.
//
// The same kernels serve u32 RNS batches (ops/hopper_rns32.py), replacing
// the JAX package's stacked u32 kernel K16 (pallas_mxu_rns.py, logn <= 17)
// and, at logn 18-25, its per-modulus split onto K6:
//   rns_u32_forward         <- _rns32_fwd_kernel (pallas_mxu_rns.py:846)
//   rns_u32_inverse         <- _rns32_inv_kernel (:857)
//   rns_u32_polymul_inverse <- _rns32_inv_kernel with the Barrett product
//                              fused into its first load (the JAX package
//                              leaves the product unfused)
// Each kernel is a template over where a ring's constants come from
// (merge_u32.cuh): the launch's arguments for one modulus, or for RNS the
// ring's schedule entry, which picks its modulus's rows of the stacked
// tables and constants.  Every block reads one modulus, once.  Below logn
// 14 a row block of one modulus holds 2^13 / N rings; an RNS schedule's
// neighbouring rings may name different moduli, so there a row block
// holds only the rings of one schedule entry (one ring for a schedule of
// one entry per ring) and its tile shrinks to fit them: each ring gets a
// block of its own rather than per-ring constants inside a block.
//
// Choice: butterflies, not digits.  K5/K6 cut each product into radix-256
// int8 digit matmuls and K4 rolls sublanes under masks, because the TPU
// has no wide multiplier.  This card multiplies 32 x 32 -> 64 natively
// (__umulhi), so each stage is the reference's radix-2 butterfly with a
// 32-bit Shoup constant product.  Every stage keeps canonical residues
// (not K4's lazy [0, 4q)), so the values at the phase boundary equal the
// engine's and the plain versions can split the network at the same stage.
//
// Two phases through device memory, as merge_u64.cu.  The ring is an
// (A, B) matrix, element j at (j / B, j % B):
//   - the first log A stages pair elements B * t apart and run down the
//     columns; a block takes C = W / A adjacent columns of one ring;
//   - the last log B stages pair elements within a row; a block takes
//     W / B whole rows (several rings when B = N).  Row a, local stage l,
//     group i reads entry (a << l) + i of the one bit-reversed table
//     (offset by the stage's 2^s for X^N + 1), so the TPU's W matrix and
//     K6's factored W need no pass of their own.
// The inverse runs rows first, then columns, then n^-1.
//
// Split rule (one rule for logn 8-25; hopper_merge32.split mirrors it):
//   B = 2^min(logn, 13) up to logn 22, B = 2^15 for logn 23-25; A = N / B;
//   the tile holds W = max(B, 2^13) u32 words: 32 KiB up to logn 22,
//   128 KiB above, as dynamic shared memory (cudaFuncSetAttribute past
//   48 KB).  logn <= 13 has A = 1: one launch over whole rings, 2^13 / N
//   rings per block, with the reduce (and the n^-1 scaling) in that launch.
//   logn 14-22: A = 2..512, C = 2^13 / A = 4096..16 columns.
//   logn 23-25: A = 256..1024, C = 128..32 columns.
//
// Lanes: the port's u32 data are int64 tensors holding values < 2^32, so
// each kernel loads 8-byte words, keeps its tile in 32-bit words and
// stores 8-byte words (twice the bytes of a uint32 layout).
//
// Bound: at 2^16 x 128 (64 MiB of int64 lanes per operand) a transform
// must read and write the batch once, 128 MiB (0.040 ms at 3.35 TB/s);
// the two phases move it twice.  Its 2^26 butterflies of three 32-bit
// multiplies each are far below the integer throughput, so the function
// is bound by device memory.  On the H100 the launches are not: a row
// launch runs 13 stages, each a barrier and a pass over shared memory,
// at ~0.8-1.0 TB/s, while the 3-stage column launch at 2^16 moves its
// bytes at ~2.2 TB/s (PERF.md section 5).  Fewer barriers per stage
// (radix-4/8 in registers) is the remedy, left to a later change.
// Tensor cores, TMA and clusters are not used.
//
// An RNS batch adds its ring's modulus's tables to each block's reads:
// 1 MiB of table and Shoup companion per modulus at 2^16 for X^N + 1,
// 8 MiB for a ladder of 8, which L2 (50 MB) holds.
//
// Value bound: q < 2^30, so canonical sums (< 2q) and lazy Shoup results
// (< 2q) stay inside the word (merge_u32.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u32.cuh"

namespace merge_u32 {
namespace {

constexpr int kThreads = 256;
constexpr int kLogTile = 13;       // log2 words of the smallest tile (32 KiB)
constexpr int kLogTileLarge = 15;  // log2 words of the largest tile (128 KiB)

// Cooley-Tukey stages 0 .. logA-1 down the columns of an (A, 2^logC) tile.
__device__ void ct_cols(uint32_t* s, int logA, int logC, const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint32_t q, int xnp) {
  const int work = 1 << (logA - 1 + logC);
  for (int l = 0; l < logA; ++l) {
    const int logt = logA - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int idx = xnp ? (1 << l) + i : i;
      const uint32_t u = s[p0];
      const uint32_t v = shoup_mul(s[p1], (uint32_t)tw[idx], (uint32_t)tws[idx], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages logA-1 .. 0 down the columns.
__device__ void gs_cols(uint32_t* s, int logA, int logC, const uint64_t* __restrict__ tw,
                        const uint64_t* __restrict__ tws, uint32_t q, int xnp) {
  const int work = 1 << (logA - 1 + logC);
  for (int l = logA - 1; l >= 0; --l) {
    const int logt = logA - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int idx = xnp ? (1 << l) + i : i;
      const uint32_t u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), (uint32_t)tw[idx], (uint32_t)tws[idx], q);
    }
    __syncthreads();
  }
}

// Cooley-Tukey stages logA .. logn-1 along `rows` rows of length 2^logB;
// the tile's first row is global row r0 (ring r0 >> logA, row r0 % A).
__device__ void ct_rows(uint32_t* s, int rows, int r0, int logA, int logB,
                        const uint64_t* __restrict__ tw, const uint64_t* __restrict__ tws,
                        uint32_t q, int xnp) {
  const int work = rows << (logB - 1);
  const int amask = (1 << logA) - 1;
  for (int l = 0; l < logB; ++l) {
    const int logt = logB - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (logB - 1), bf = k & ((1 << (logB - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << logB) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const int g = (((r0 + j) & amask) << l) + i;
      const int idx = xnp ? (1 << (logA + l)) + g : g;
      const uint32_t u = s[p0];
      const uint32_t v = shoup_mul(s[p1], (uint32_t)tw[idx], (uint32_t)tws[idx], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages logn-1 .. logA along rows.
__device__ void gs_rows(uint32_t* s, int rows, int r0, int logA, int logB,
                        const uint64_t* __restrict__ tw, const uint64_t* __restrict__ tws,
                        uint32_t q, int xnp) {
  const int work = rows << (logB - 1);
  const int amask = (1 << logA) - 1;
  for (int l = logB - 1; l >= 0; --l) {
    const int logt = logB - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (logB - 1), bf = k & ((1 << (logB - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << logB) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const int g = (((r0 + j) & amask) << l) + i;
      const int idx = xnp ? (1 << (logA + l)) + g : g;
      const uint32_t u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), (uint32_t)tw[idx], (uint32_t)tws[idx], q);
    }
    __syncthreads();
  }
}

// Column phase.  Block = (ring, 2^logC adjacent columns), an (A, 2^logC)
// tile.  Forward (first phase): reduce on load, CT stages.  Inverse (last
// phase): GS stages, n^-1 on store.  x may equal y.
template <bool kFwd, class F>
__global__ void __launch_bounds__(kThreads)
cols(const uint64_t* x, uint64_t* y, int logn, int logA, int logC, F fs, int xnp) {
  extern __shared__ uint32_t smem[];
  const int logB = logn - logA, tiles_log = logB - logC;
  const size_t ring = blockIdx.x >> tiles_log;
  const Ring f = fs.at(ring);
  const size_t off = (ring << logn) + ((size_t)(blockIdx.x & ((1u << tiles_log) - 1)) << logC);
  const int words = 1 << (logA + logC), cmask = (1 << logC) - 1;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const uint32_t v = (uint32_t)x[off + ((size_t)(e >> logC) << logB) + (e & cmask)];
    smem[e] = kFwd ? reduce_any(v, f.q, f.one_s) : v;
  }
  __syncthreads();
  if (kFwd)
    ct_cols(smem, logA, logC, f.tw, f.tws, f.q, xnp);
  else
    gs_cols(smem, logA, logC, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + ((size_t)(e >> logC) << logB) + (e & cmask)] =
        kFwd ? smem[e] : shoup_mul(smem[e], f.n_inv, f.n_inv_s, f.q);
}

// Row phase.  Block = 2^log_rows consecutive rows of the (batch * A, B)
// view, the last block possibly short, all under one modulus (the
// launcher caps log_rows by F::ring_log).  `reduce`: reduce on load (the
// first phase); `scale`: n^-1 on store (the inverse's last phase).  kMul:
// the load is the Barrett product x o b, then reduced (the polymul's
// inverse).  x may equal y.
template <bool kFwd, bool kMul, class F>
__global__ void __launch_bounds__(kThreads)
rows(const uint64_t* x, const uint64_t* b, uint64_t* y, int total_rows, int logA, int logB,
     int log_rows, F fs, int reduce, int scale, int xnp) {
  extern __shared__ uint32_t smem[];
  const int r0 = (int)(blockIdx.x << log_rows);
  const int left = total_rows - r0;
  const int nrows = left < (1 << log_rows) ? left : (1 << log_rows);
  const int words = nrows << logB;
  const size_t off = (size_t)r0 << logB;
  const Ring f = fs.at((size_t)r0 >> logA);
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const uint32_t v = kMul ? barrett_mul((uint32_t)x[off + e], (uint32_t)b[off + e], f.q,
                                          f.bit, f.mu)
                            : (uint32_t)x[off + e];
    smem[e] = reduce ? reduce_any(v, f.q, f.one_s) : v;
  }
  __syncthreads();
  if (kFwd)
    ct_rows(smem, nrows, r0, logA, logB, f.tw, f.tws, f.q, xnp);
  else
    gs_rows(smem, nrows, r0, logA, logB, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + e] = scale ? shoup_mul(smem[e], f.n_inv, f.n_inv_s, f.q) : smem[e];
}

// log2 words of a block's tile for rows of 2^logB words.
int tile_log(int logB) { return logB > kLogTile ? logB : kLogTile; }

// Shapes the tiles cover: rows of at most 2^15 words, and a column tile
// of whole columns that is no wider than a row.
bool shape_ok(long long batch, int logn, int logA) {
  const int logB = logn - logA;
  if (batch <= 0 || logA < 0 || logB < 1 || logB > kLogTileLarge) return false;
  const int logW = tile_log(logB);
  if (logA > 0 && (logA > logW || logW > logn)) return false;
  // every row index and grid size fits an int
  return batch < (1LL << 31) && (batch << logA) < (1LL << 31) &&
         ((batch << logn) >> logW) < (1LL << 31);
}

int grid_cols(long long batch, int logn, int logA) {
  const int logB = logn - logA;
  return (int)(batch << (logB - (tile_log(logB) - logA)));
}

// log2 rows of a row block: a tile's worth, no more than F puts in one
// modulus's run of rings (2^(logA + ring_log) rows).
template <class F>
int rows_log(int logA, int logB, const F& f) {
  const int fit = tile_log(logB) - logB, run = logA + f.ring_log();
  return fit < run ? fit : run;
}

int grid_rows(long long batch, int logA, int log_rows) {
  return (int)(((batch << logA) + (1LL << log_rows) - 1) >> log_rows);
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed past 48 KB).
template <class K>
int fit_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
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
int forward(const uint64_t* x, uint64_t* y, long long batch, int logn, int logA, F f, int xnp,
            cudaStream_t st) {
  const int logB = logn - logA, logW = tile_log(logB);
  if (logA > 0) {
    const int bytes = 4 << logW;
    if (int rc = fit_smem(cols<true, F>, bytes)) return rc;
    cols<true, F><<<grid_cols(batch, logn, logA), kThreads, bytes, st>>>(
        x, y, logn, logA, logW - logA, f, xnp);
    if (int rc = launch_status()) return rc;
  }
  const int log_rows = rows_log(logA, logB, f), bytes = 4 << (logB + log_rows);
  if (int rc = fit_smem(rows<true, false, F>, bytes)) return rc;
  rows<true, false, F><<<grid_rows(batch, logA, log_rows), kThreads, bytes, st>>>(
      logA > 0 ? y : x, nullptr, y, (int)(batch << logA), logA, logB, log_rows, f, logA == 0,
      0, xnp);
  return launch_status();
}

// kMul: INTT(a o b); otherwise INTT(a) (b unused).
template <bool kMul, class F>
int inverse(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, int logn,
            int logA, F f, int xnp, cudaStream_t st) {
  const int logB = logn - logA, logW = tile_log(logB);
  const int log_rows = rows_log(logA, logB, f), bytes = 4 << (logB + log_rows);
  if (int rc = fit_smem(rows<false, kMul, F>, bytes)) return rc;
  rows<false, kMul, F><<<grid_rows(batch, logA, log_rows), kThreads, bytes, st>>>(
      a, b, y, (int)(batch << logA), logA, logB, log_rows, f, 1, logA == 0, xnp);
  if (int rc = launch_status()) return rc;
  if (logA > 0) {
    const int bytes = 4 << logW;
    if (int rc = fit_smem(cols<false, F>, bytes)) return rc;
    cols<false, F><<<grid_cols(batch, logn, logA), kThreads, bytes, st>>>(
        y, y, logn, logA, logW - logA, f, xnp);
  }
  return launch_status();
}

OneModulus one_modulus(const uint64_t* tw, const uint64_t* tws, uint32_t q, uint32_t one_s,
                       uint32_t n_inv = 0, uint32_t n_inv_s = 0) {
  return OneModulus{Ring{tw, tws, q, one_s, n_inv, n_inv_s, 0, 0}};
}

// The stacked tables of an RNS schedule: 2^logn entries per modulus for
// X^N + 1, 2^(logn-1) for X^N - 1.
Stacked rns(const int* mod_idx, int shift, int logn, const uint64_t* tw, const uint64_t* tws,
            const uint64_t* consts, int xnp) {
  return Stacked{mod_idx, shift, tw, tws, xnp ? 1LL << logn : 1LL << (logn - 1), consts};
}

}  // namespace
}  // namespace merge_u32

using namespace merge_u32;

// Every entry: pointers to contiguous (batch, 2^logn) int64 lanes holding
// u32 words on card `device` (only the low 32 bits of each input word are
// read), launches on `stream`, allocates nothing, does not synchronise,
// and returns the cudaError_t of its launches (0 = none).  logA is log2 of
// the column count A of the split (hopper_merge32.split); x may equal y.
// The merge_u32_* entries take one modulus: its table and Shoup companion
// as int64 words, and its numbers.  The rns_u32_* entries take an int32
// schedule of batch >> shift moduli (ring i uses modulus
// mod_idx[i >> shift], every entry in [0, mod_count)), the stacked
// (mod_count, table) tables and the (mod_count, 6) constants of
// ops/rns.py's RNSMergePlan.
extern "C" {

int merge_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch,
                      int logn, int logA, const uint64_t* tw, const uint64_t* tws,
                      uint32_t q, uint32_t one_s, int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, one_modulus(tw, tws, q, one_s), xnp,
                 (cudaStream_t)stream);
}

int merge_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch,
                      int logn, int logA, const uint64_t* tw, const uint64_t* tws,
                      uint32_t q, uint32_t one_s, uint32_t n_inv, uint32_t n_inv_s,
                      int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn, logA,
                        one_modulus(tw, tws, q, one_s, n_inv, n_inv_s), xnp,
                        (cudaStream_t)stream);
}

int rns_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, rns(mod_idx, shift, logn, tw, tws, consts, xnp),
                 xnp, (cudaStream_t)stream);
}

int rns_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn, logA,
                        rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                        (cudaStream_t)stream);
}

int rns_u32_polymul_inverse(int device, const uint64_t* fa, const uint64_t* fb, uint64_t* y,
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
