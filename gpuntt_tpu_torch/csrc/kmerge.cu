// Hopper kernels of the factored merge NTT, u64 and u32 (sm_90a).
//
// They replace the JAX package's VPU merge kernels, whose plan is
// KernelMergePlan (ops/hopper_kmerge.py here):
//   kmerge_u64_forward <- K15 _fwd_kernel64   (pallas_merge64.py:74, entry pallas_merge2_u64)
//   kmerge_u64_inverse <- K15 _inv_kernel64   (pallas_merge64.py:105)
//   kmerge_u32_forward <- K17 _fwd_kernel_u32 (pallas_merge.py:218, entry pallas_merge_u32)
//   kmerge_u32_inverse <- K17 _inv_kernel_u32 (pallas_merge.py:255)
// and compute what those compute: the merged NTT of each (batch, N) row
// in the reference's bit-reversed output order, and its inverse with the
// n^-1 scaling last, in canonical residues.  Any input word is first
// reduced mod q (the low 32 bits of it for u32), as merge_u64.cu does.
//
// The factorization is the TPU kernels' (pallas_merge.py:1-27): the ring
// is an (A, 128) matrix, element j at (j / 128, j % 128); the forward is
// log A Cooley-Tukey stages down the columns (the merge network's first
// stages, twiddles from the column prefix of the bit-reversed table), the
// product by W[a, b], then one 128-point merge NTT along every row (the
// 64-entry row table, X^N - 1 indexing); the inverse is the mirror:
// Gentleman-Sande row stages, W^-1, the column stages, n^-1.  The TPU
// kernels roll sublanes under masks and transpose in VMEM so that the
// row stages run on sublanes; here a shared-memory tile is addressed
// directly, so a butterfly names its pair and no transpose is needed.
//
// Forms (one rule for both word sizes; kLogTile, the log2 words of the
// largest tile, is 14 for u64 and 15 for u32, 128 KiB either way):
//   - logn <= kLogTile: one block per ring holds the whole (A, 128) tile
//     in dynamic shared memory and runs the column stages, W and the row
//     stages in one pass over device memory (u64 logn 7-14, u32 7-15);
//   - above: column launches through device memory, each taking up to
//     2^(kLogColTile - kLogCols) = 512 rows by 16 adjacent columns (128
//     bytes of int64 lanes a row) of one ring and a run of consecutive
//     stages (the rows a run pairs share their top s0 and bottom bits), as
//     many as the log A stages need (one up to log A = 9, logn 16; two up
//     to log A = 18); then one row launch over 2^(kLogRowTile - 7) = 32
//     rows of 128 words, with W fused into its load (forward) or store
//     (inverse).  The inverse runs the row launch first and scales by
//     n^-1 in its last column launch.
// 256 threads a block, one __syncthreads per stage.
//
// Value policy: every butterfly keeps canonical residues (< q).  u64: a
// sum is < 2q and u + q - v < 2q, both < 2^64 for q < 2^63, and the Shoup
// product x * w - umulhi(x, w') * q lies in [0, 2q) for any x and w < q,
// so one policy is exact for every q < 2^63 (merge_u64.cuh's arithmetic,
// whose bounds hold there too), the 62-bit pool and q in [2^62, 2^63)
// alike.  The JAX kernel's lazy Harvey stages keep [0, 4q) and need
// 4q < 2^64; canonical stages cost one conditional subtract more each and
// need no second policy.  u32: q < 2^30 (merge_u32.cuh).
//
// Bound: at u64 2^16 x 128 a transform must read and write the batch
// once, 128 MiB (0.040 ms at 3.35 TB/s); the two launches move it twice,
// and W (1 MiB of table and companion) is read by every ring, which L2
// holds.  Its 2^26 butterflies and 2^23 W products, a Shoup product each
// of 16 32-bit multiplies, are 1.2 x 10^9 multiplies, 0.018 ms at 67 T/s:
// bytes bound it.
// Tensor cores, TMA and clusters are not used: a simple form first.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u32.cuh"
#include "merge_u64.cuh"

namespace kmerge {
namespace {

constexpr int kThreads = 256;
constexpr int kLogRow = 7;       // the 128-word rows (the TPU's lane width)
constexpr int kLogCols = 4;      // columns of a column-launch tile
constexpr int kLogColTile = 13;  // most words of a column-launch tile
constexpr int kLogRowTile = 12;  // most words of a row-launch tile

// One overload per word size: merge_u32.cuh's for uint32_t operands,
// merge_u64.cuh's for uint64_t.
using merge_u32::add_mod;
using merge_u32::reduce_any;
using merge_u32::shoup_mul;
using merge_u32::sub_mod;
using merge_u64::add_mod;
using merge_u64::reduce_any;
using merge_u64::shoup_mul;
using merge_u64::sub_mod;

// The tables of one direction (int64 words holding the values), each
// with its Shoup companion: the column prefix (2A entries for X^N + 1, A
// for X^N - 1), the (A, 128) W, the 64-entry row table.
struct Tables {
  const uint64_t* col;
  const uint64_t* cols;
  const uint64_t* w;
  const uint64_t* ws;
  const uint64_t* row;
  const uint64_t* rows;
};

// The modulus's numbers: q, floor(2^word / q), n^-1 and its companion.
template <class T>
struct Consts {
  T q, one_s, n_inv, n_inv_s;
};

// Cooley-Tukey stages s0 .. s0+L-1 of the column network on a (2^L, 2^logC)
// tile: local row m is row (((hi << L) + m) << lo_log) + lo of the ring,
// so local stage l pairs m and m + 2^(L-1-l), and its group (hi << l) +
// (m >> (L - l)) reads table entry (X^N + 1 ? 2^(s0+l) : 0) + group.
template <class T>
__device__ void ct_cols(T* s, int L, int logC, int s0, int hi, Tables t, T q, int xnp) {
  const int work = 1 << (L - 1 + logC);
  for (int l = 0; l < L; ++l) {
    const int logt = L - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int g = (hi << l) + i, idx = xnp ? (1 << (s0 + l)) + g : g;
      const T u = s[p0];
      const T v = shoup_mul(s[p1], (T)t.col[idx], (T)t.cols[idx], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Gentleman-Sande stages s0+L-1 .. s0 on the same tile, no scaling.
template <class T>
__device__ void gs_cols(T* s, int L, int logC, int s0, int hi, Tables t, T q, int xnp) {
  const int work = 1 << (L - 1 + logC);
  for (int l = L - 1; l >= 0; --l) {
    const int logt = L - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int c = k & ((1 << logC) - 1), bf = k >> logC;
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (((i << (logt + 1)) + r) << logC) + c;
      const int p1 = p0 + (1 << (logt + logC));
      const int g = (hi << l) + i, idx = xnp ? (1 << (s0 + l)) + g : g;
      const T u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), (T)t.col[idx], (T)t.cols[idx], q);
    }
    __syncthreads();
  }
}

// The 128-point row NTT on `rows` rows of a tile: stage l, group i reads
// row-table entry i (X^N - 1 indexing).
template <class T>
__device__ void ct_rows(T* s, int rows, Tables t, T q) {
  const int work = rows << (kLogRow - 1);
  for (int l = 0; l < kLogRow; ++l) {
    const int logt = kLogRow - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (kLogRow - 1), bf = k & ((1 << (kLogRow - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << kLogRow) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const T u = s[p0];
      const T v = shoup_mul(s[p1], (T)t.row[i], (T)t.rows[i], q);
      s[p0] = add_mod(u, v, q);
      s[p1] = sub_mod(u, v, q);
    }
    __syncthreads();
  }
}

// Its Gentleman-Sande inverse, no scaling.
template <class T>
__device__ void gs_rows(T* s, int rows, Tables t, T q) {
  const int work = rows << (kLogRow - 1);
  for (int l = kLogRow - 1; l >= 0; --l) {
    const int logt = kLogRow - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (kLogRow - 1), bf = k & ((1 << (kLogRow - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << kLogRow) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const T u = s[p0], v = s[p1];
      s[p0] = add_mod(u, v, q);
      s[p1] = shoup_mul(sub_mod(u, v, q), (T)t.row[i], (T)t.rows[i], q);
    }
    __syncthreads();
  }
}

// One block per ring: the whole (A, 128) tile.  x may equal y.
template <class T, bool kFwd>
__global__ void __launch_bounds__(kThreads)
whole(const uint64_t* x, uint64_t* y, int logn, Tables t, Consts<T> k, int xnp) {
  extern __shared__ uint64_t smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int logA = logn - kLogRow, words = 1 << logn;
  const size_t off = (size_t)blockIdx.x << logn;
  for (int e = threadIdx.x; e < words; e += kThreads)
    s[e] = reduce_any((T)x[off + e], k.q, k.one_s);
  __syncthreads();
  if (kFwd) {
    ct_cols(s, logA, kLogRow, 0, 0, t, k.q, xnp);
    for (int e = threadIdx.x; e < words; e += kThreads)
      s[e] = shoup_mul(s[e], (T)t.w[e], (T)t.ws[e], k.q);
    __syncthreads();
    ct_rows(s, 1 << logA, t, k.q);
    for (int e = threadIdx.x; e < words; e += kThreads) y[off + e] = s[e];
  } else {
    gs_rows(s, 1 << logA, t, k.q);
    for (int e = threadIdx.x; e < words; e += kThreads)
      s[e] = shoup_mul(s[e], (T)t.w[e], (T)t.ws[e], k.q);
    __syncthreads();
    gs_cols(s, logA, kLogRow, 0, 0, t, k.q, xnp);
    for (int e = threadIdx.x; e < words; e += kThreads)
      y[off + e] = shoup_mul(s[e], k.n_inv, k.n_inv_s, k.q);
  }
}

// Column stages s0 .. s0+L-1 of the (A, 128) view.  Block = (ring, hi, lo,
// column tile): rows ((hi << L) + m) << lo_log | lo, m < 2^L, of 16 adjacent
// columns.  Forward: reduce on load (`reduce`, the first launch), CT
// stages.  Inverse: GS stages, n^-1 on store (`scale`, the last launch).
// x may equal y.
template <class T, bool kFwd>
__global__ void __launch_bounds__(kThreads)
cols(const uint64_t* x, uint64_t* y, int logn, int s0, int L, Tables t, Consts<T> k,
     int reduce, int scale, int xnp) {
  extern __shared__ uint64_t smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int logA = logn - kLogRow, lo_log = logA - s0 - L;
  size_t b = blockIdx.x;
  const int ctile = (int)(b & ((1u << (kLogRow - kLogCols)) - 1));
  b >>= kLogRow - kLogCols;
  const size_t lo = b & (((size_t)1 << lo_log) - 1);
  b >>= lo_log;
  const int hi = (int)(b & ((1u << s0) - 1));
  const size_t ring = b >> s0;
  const size_t base = (ring << logn) + ((((size_t)hi << (L + lo_log)) | lo) << kLogRow) +
                      ((size_t)ctile << kLogCols);
  const int words = 1 << (L + kLogCols), cmask = (1 << kLogCols) - 1;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const T v = (T)x[base + ((size_t)(e >> kLogCols) << (lo_log + kLogRow)) + (e & cmask)];
    s[e] = reduce ? reduce_any(v, k.q, k.one_s) : v;
  }
  __syncthreads();
  if (kFwd)
    ct_cols(s, L, kLogCols, s0, hi, t, k.q, xnp);
  else
    gs_cols(s, L, kLogCols, s0, hi, t, k.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[base + ((size_t)(e >> kLogCols) << (lo_log + kLogRow)) + (e & cmask)] =
        scale ? shoup_mul(s[e], k.n_inv, k.n_inv_s, k.q) : s[e];
}

// Row launch: 2^log_rows consecutive 128-word rows of the (batch * A, 128)
// view, the last block possibly short.  Forward: W on load, the row NTT.
// Inverse: reduce on load, the row inverse, W^-1 on store.  x may equal y.
template <class T, bool kFwd>
__global__ void __launch_bounds__(kThreads)
rows(const uint64_t* x, uint64_t* y, long long total_rows, int logA, int log_rows, Tables t,
     Consts<T> k) {
  extern __shared__ uint64_t smem[];
  T* s = reinterpret_cast<T*>(smem);
  const long long r0 = (long long)blockIdx.x << log_rows;
  const long long left = total_rows - r0;
  const int nrows = left < (1LL << log_rows) ? (int)left : (1 << log_rows);
  const int words = nrows << kLogRow;
  const size_t off = (size_t)r0 << kLogRow;
  // W's entry for tile word e: row (r0 + e / 128) % A of the ring, column e % 128
  const size_t wmask = ((size_t)1 << (logA + kLogRow)) - 1;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const T v = (T)x[off + e];
    const size_t we = (off + e) & wmask;
    s[e] = kFwd ? shoup_mul(v, (T)t.w[we], (T)t.ws[we], k.q) : reduce_any(v, k.q, k.one_s);
  }
  __syncthreads();
  if (kFwd)
    ct_rows(s, nrows, t, k.q);
  else
    gs_rows(s, nrows, t, k.q);
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const size_t we = (off + e) & wmask;
    y[off + e] = kFwd ? s[e] : shoup_mul(s[e], (T)t.w[we], (T)t.ws[we], k.q);
  }
}

// log2 words of the largest whole-ring tile of a word size: 128 KiB of
// shared memory.
template <class T>
constexpr int kLogTile = sizeof(T) == 8 ? 14 : 15;

// Shapes the kernels take: logn 7-25, every grid size an int.
bool shape_ok(long long batch, int logn) {
  if (batch <= 0 || logn < kLogRow || logn > 25) return false;
  return batch < (1LL << 31) && (batch << (logn - kLogCols)) < (1LL << 31);
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

// One whole-ring launch (logn <= kLogTile).
template <class T, bool kFwd>
int run_whole(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
              const Consts<T>& k, int xnp, cudaStream_t st) {
  const int bytes = (int)sizeof(T) << logn;
  if (int rc = fit_smem(whole<T, kFwd>, bytes)) return rc;
  whole<T, kFwd><<<(int)batch, kThreads, bytes, st>>>(x, y, logn, t, k, xnp);
  return launch_status();
}

// The column launches: the log A stages in runs of at most
// kLogColTile - kLogCols, as even as they come; forward in
// ascending order from x (reduced on load), inverse in descending order in
// place (n^-1 on the last store).
template <class T, bool kFwd>
int run_cols(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
             const Consts<T>& k, int xnp, cudaStream_t st) {
  const int logA = logn - kLogRow;
  const int most = kLogColTile - kLogCols;
  const int runs = (logA + most - 1) / most;
  int bounds[32];
  bounds[0] = 0;
  for (int p = 0; p < runs; ++p) bounds[p + 1] = bounds[p] + (logA - bounds[p]) / (runs - p);
  for (int j = 0; j < runs; ++j) {
    const int p = kFwd ? j : runs - 1 - j;
    const int s0 = bounds[p], L = bounds[p + 1] - bounds[p];
    const int bytes = (int)sizeof(T) << (L + kLogCols);
    if (int rc = fit_smem(cols<T, kFwd>, bytes)) return rc;
    cols<T, kFwd><<<(int)(batch << (logA - L + kLogRow - kLogCols)), kThreads, bytes, st>>>(
        j == 0 ? x : y, y, logn, s0, L, t, k, kFwd && j == 0, !kFwd && j == runs - 1, xnp);
    if (int rc = launch_status()) return rc;
  }
  return 0;
}

// The row launch.
template <class T, bool kFwd>
int run_rows(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
             const Consts<T>& k, cudaStream_t st) {
  const int logA = logn - kLogRow;
  const int log_rows = kLogRowTile - kLogRow;
  const long long total = batch << logA;
  const int bytes = (int)sizeof(T) << (log_rows + kLogRow);
  if (int rc = fit_smem(rows<T, kFwd>, bytes)) return rc;
  rows<T, kFwd><<<(int)((total + (1LL << log_rows) - 1) >> log_rows), kThreads, bytes, st>>>(
      x, y, total, logA, log_rows, t, k);
  return launch_status();
}

template <class T>
int forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
            const Tables& t, const Consts<T>& k, int xnp, cudaStream_t st) {
  if (!shape_ok(batch, logn)) return (int)cudaErrorInvalidValue;
  if (int rc = (int)cudaSetDevice(device)) return rc;
  if (logn <= kLogTile<T>) return run_whole<T, true>(x, y, batch, logn, t, k, xnp, st);
  if (int rc = run_cols<T, true>(x, y, batch, logn, t, k, xnp, st)) return rc;
  return run_rows<T, true>(y, y, batch, logn, t, k, st);
}

template <class T>
int inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
            const Tables& t, const Consts<T>& k, int xnp, cudaStream_t st) {
  if (!shape_ok(batch, logn)) return (int)cudaErrorInvalidValue;
  if (int rc = (int)cudaSetDevice(device)) return rc;
  if (logn <= kLogTile<T>) return run_whole<T, false>(x, y, batch, logn, t, k, xnp, st);
  if (int rc = run_rows<T, false>(x, y, batch, logn, t, k, st)) return rc;
  return run_cols<T, false>(y, y, batch, logn, t, k, xnp, st);
}

}  // namespace
}  // namespace kmerge

using namespace kmerge;

// Every entry: pointers to contiguous (batch, 2^logn) int64 lanes on card
// `device` (u64 bit patterns, or u32 values of which the low 32 bits are
// read), the direction's tables as int64 words with their companions
// (KernelMergePlan.tables), q and floor(2^word / q), for the inverse n^-1
// and its companion; logn 7-25.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the cudaError_t of its launches (0 = none).  x may equal y.
extern "C" {

int kmerge_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* ws, const uint64_t* row, const uint64_t* rows,
                       uint64_t q, uint64_t one_s, int xnp, void* stream) {
  return forward<uint64_t>(device, x, y, batch, logn,
                           Tables{col, cols, w, ws, row, rows},
                           Consts<uint64_t>{q, one_s, 0, 0}, xnp, (cudaStream_t)stream);
}

int kmerge_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* ws, const uint64_t* row, const uint64_t* rows,
                       uint64_t q, uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s,
                       int xnp, void* stream) {
  return inverse<uint64_t>(device, x, y, batch, logn,
                           Tables{col, cols, w, ws, row, rows},
                           Consts<uint64_t>{q, one_s, n_inv, n_inv_s}, xnp,
                           (cudaStream_t)stream);
}

int kmerge_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* ws, const uint64_t* row, const uint64_t* rows,
                       uint32_t q, uint32_t one_s, int xnp, void* stream) {
  return forward<uint32_t>(device, x, y, batch, logn,
                           Tables{col, cols, w, ws, row, rows},
                           Consts<uint32_t>{q, one_s, 0, 0}, xnp, (cudaStream_t)stream);
}

int kmerge_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* ws, const uint64_t* row, const uint64_t* rows,
                       uint32_t q, uint32_t one_s, uint32_t n_inv, uint32_t n_inv_s,
                       int xnp, void* stream) {
  return inverse<uint32_t>(device, x, y, batch, logn,
                           Tables{col, cols, w, ws, row, rows},
                           Consts<uint32_t>{q, one_s, n_inv, n_inv_s}, xnp,
                           (cudaStream_t)stream);
}

}  // extern "C"
