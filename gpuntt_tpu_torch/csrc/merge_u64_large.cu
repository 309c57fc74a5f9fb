// Hopper kernels of the u64 big-ring merge NTT, logn 18-28 (sm_90a).
//
// They replace two Pallas kernels of gpuntt_tpu/ops/pallas_mxu_large.py:
//   merge_u64_large_colfwd  <- _colfwd_kernel     (K7 forward, :388)
//   merge_u64_large_colinv  <- _colinv_kernel     (K7 inverse, :398)
//   merge_u64_large_rowmat  <- _row_matmul_kernel (K8, :499), both directions
// and compute what those compute.  The ring is an (A, B) matrix, element
// j at (j / B, j % B), and the transform is three steps
// (hopper_merge_large.py holds the plan and composes them):
//   1. an A-point merge NTT down every column, with the column plan's
//      bit-reversed table (root psi^B for X^N + 1, omega^B for X^N - 1);
//   2. the twist by W[a, b] = w_a^b, factored as an (A, T) tile table
//      times a per-tile scale (B / T, A), so no N-entry table exists;
//   3. a B-point X^B - 1 merge NTT along every row: K8 below for B <= 512,
//      the kernels of merge_u64.cu for B = 2^11..2^17, a nested plan
//      beyond (logn 27-28).
// The inverse runs the rows first (B^-1 folded in), then W^-1, then the
// column inverse with A^-1 folded in.  Outputs are canonical residues
// (the TPU's forward column kernel leaves them below 3q), bit-identical
// to the plain versions, and like the TPU kernels any u64 input word is
// first reduced mod q.
//
// Choice: butterflies, not digits.  The TPU kernels multiply by the
// column matrix (and K8 by the row matrix) as int8 digit matmuls on the
// MXU, because the TPU has no wide multiplier.  This card multiplies
// 64 x 64 -> 128 natively (__umul64hi), so each matrix product is the
// radix-2 merge network of Shoup butterflies, as in merge_u64.cu.
//
// K7, the column phase: a block takes C adjacent columns of one ring, an
// A x C tile of 2^13 words (64 KiB of dynamic shared memory, past the
// 48 KB static limit) or the whole ring when it is smaller; C = 16 at
// A = 512, 64 at A = 128.  One __syncthreads per stage.
// K8, whole rows: a block takes 4096 / B rows of B <= 512 words (32 KiB of
// static shared memory), the last block short when the rows do not
// fill it, and runs all log B stages.
//
// Bound: each launch reads and writes its operand once; at 2^24 x 1
// that is 256 MiB, 0.080 ms at 3.35 TB/s, against log A + 2 Shoup
// products per word for K7 (2^24 * 9 products at 67 T/s: 0.002 ms).  So
// the function is bound by device memory, and, as for merge_u64.cu, the
// launches are held by per-stage barrier and shared-memory latency.
// Tensor cores, TMA and clusters are not used.
//
// K7' (col_phase_local, :452, via _colfwd_kernel / _colinv_kernel): the
// distributed 4-step's fused column phase on one shard's B / sp columns.
// merge_u64_large_colfwd_local / _colinv_local launch the same two kernels
// on the (batch, A, B / sp) slice, with logB the slice's width and the
// scale table's pointers moved to the shard's first tile.  The twist
// indexes ws[b >> logT] by the local column b; with B / sp a multiple of
// T, b mod T is the same locally and globally, so that offset is all it
// takes to multiply by W at the global column indices.  Bound: the
// slice's bytes, read once and written once (0.020 ms a shard at 2^24 /
// 4); design and limits are K7's.
//
// RNS (K13, ops/hopper_rns.py): the same kernels replace the stacked ones
// of gpuntt_tpu/ops/pallas_mxu_rns.py,
//   rns_u64_large_colfwd  <- _rns_colfwd_kernel (:375)
//   rns_u64_large_colinv  <- _rns_colinv_kernel (:388)
//   rns_u64_large_rowmat  <- _rns_rowmat_kernel (:448)
// as templates over where a ring's constants come from (merge_u64.cuh):
// a block of the column kernels covers columns of one ring and reads its
// modulus's stacked column and twist tables; a row block's rows lie in
// one ring (rns_u64_large_rowmat refuses a schedule where they would
// not), whose modulus it reads once.
//
// Index width: at 2^28 a ring is 2^28 words, so every global offset is a
// size_t; col_shape_ok and row_shape_ok keep every grid within 2^31 blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u64_large.cuh"

namespace merge_u64_large {
namespace {

using merge_u64::add_mod;
using merge_u64::ct_cols;
using merge_u64::gs_cols;
using merge_u64::one_modulus;
using merge_u64::OneModulus;
using merge_u64::reduce_any;
using merge_u64::Ring;
using merge_u64::Stacked;
using merge_u64::stacked;
using merge_u64::shoup_mul;
using merge_u64::sub_mod;
using merge_u64::twist;

constexpr int kThreads = 256;
constexpr int kLogColTile = 13;  // K7 tile: 2^13 words (64 KiB)
constexpr int kLogRowTile = 12;  // K8 tile: 2^12 words (32 KiB)

// K7 forward: block = (ring, C columns); x -> y.  Reduce, CT stages, twist.
template <class F>
__global__ void __launch_bounds__(kThreads)
col_fwd(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int logA, int logB,
        int logC, F fs, int logT, int xnp) {
  extern __shared__ uint64_t smem[];
  const size_t ring = blockIdx.x >> (logB - logC);
  const Ring f = fs.at(ring);
  const int b0 = (blockIdx.x & ((1 << (logB - logC)) - 1)) << logC;
  const size_t off = (ring << (logA + logB)) + b0;
  const int words = 1 << (logA + logC), cmask = (1 << logC) - 1;
  for (int e = threadIdx.x; e < words; e += kThreads)
    smem[e] = reduce_any(x[off + ((size_t)(e >> logC) << logB) + (e & cmask)], f.q, f.one_s);
  __syncthreads();
  ct_cols<kThreads>(smem, logA, logC, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int a = e >> logC, c = e & cmask;
    y[off + ((size_t)a << logB) + c] =
        twist(smem[e], a, b0 + c, logA, logT, f.wt, f.wts, f.ws, f.wss, f.q);
  }
}

// K7 inverse: block = (ring, C columns); x -> y.  Reduce and twist by
// W^-1, GS stages, then c_inv = f.n_inv (A^-1 for the standard scaling).
template <class F>
__global__ void __launch_bounds__(kThreads)
col_inv(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int logA, int logB,
        int logC, F fs, int logT, int xnp) {
  extern __shared__ uint64_t smem[];
  const size_t ring = blockIdx.x >> (logB - logC);
  const Ring f = fs.at(ring);
  const int b0 = (blockIdx.x & ((1 << (logB - logC)) - 1)) << logC;
  const size_t off = (ring << (logA + logB)) + b0;
  const int words = 1 << (logA + logC), cmask = (1 << logC) - 1;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int a = e >> logC, c = e & cmask;
    smem[e] = twist(reduce_any(x[off + ((size_t)a << logB) + c], f.q, f.one_s), a, b0 + c,
                    logA, logT, f.wt, f.wts, f.ws, f.wss, f.q);
  }
  __syncthreads();
  gs_cols<kThreads>(smem, logA, logC, f.tw, f.tws, f.q, xnp);
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + ((size_t)(e >> logC) << logB) + (e & cmask)] =
        shoup_mul(smem[e], f.n_inv, f.n_inv_s, f.q);
}

// K8: whole B-point rows, 2^kLogRowTile / B of them per block; x -> y.
// Forward: CT stages.  Inverse: GS stages, then n_inv (B^-1).  The
// block's first row r0 names its ring (an RNS schedule's entry r0 >>
// shift: the rows of a block lie in one ring, row_shape_ok).
template <bool kFwd, class F>
__global__ void __launch_bounds__(kThreads)
row_mat(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, long long nrows, int logB,
        F fs, int xnp) {
  __shared__ uint64_t s[1 << kLogRowTile];
  const int log_rows = kLogRowTile - logB;
  const long long r0 = (long long)blockIdx.x << log_rows;
  const Ring f = fs.at(r0);
  const int rows = nrows - r0 < (1LL << log_rows) ? (int)(nrows - r0) : 1 << log_rows;
  const size_t off = (size_t)r0 << logB;
  const int words = rows << logB, work = rows << (logB - 1);
  for (int e = threadIdx.x; e < words; e += kThreads)
    s[e] = reduce_any(x[off + e], f.q, f.one_s);
  __syncthreads();
  for (int st = 0; st < logB; ++st) {
    const int l = kFwd ? st : logB - 1 - st, logt = logB - 1 - l;
    for (int k = threadIdx.x; k < work; k += kThreads) {
      const int j = k >> (logB - 1), bf = k & ((1 << (logB - 1)) - 1);
      const int i = bf >> logt, r = bf & ((1 << logt) - 1);
      const int p0 = (j << logB) + (i << (logt + 1)) + r, p1 = p0 + (1 << logt);
      const int idx = xnp ? (1 << l) + i : i;
      const uint64_t u = s[p0];
      if (kFwd) {
        const uint64_t v = shoup_mul(s[p1], f.tw[idx], f.tws[idx], f.q);
        s[p0] = add_mod(u, v, f.q);
        s[p1] = sub_mod(u, v, f.q);
      } else {
        const uint64_t v = s[p1];
        s[p0] = add_mod(u, v, f.q);
        s[p1] = shoup_mul(sub_mod(u, v, f.q), f.tw[idx], f.tws[idx], f.q);
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < words; e += kThreads)
    y[off + e] = kFwd ? s[e] : shoup_mul(s[e], f.n_inv, f.n_inv_s, f.q);
}

// log2 of K7's column count: the tile holds 2^kLogColTile words, or the
// whole ring when B is narrower.
int col_log(int logA, int logB) {
  const int c = kLogColTile - logA;
  return c < logB ? c : logB;
}

// Shapes K7 covers: A = 2..512 columns of B >= 2 words, a power-of-two
// tile T <= B, and a grid within 2^31 blocks.
bool col_shape_ok(long long batch, int logA, int logB, int logT) {
  return batch > 0 && logA >= 1 && logA <= 9 && logB >= 1 && logB <= 30 && logT >= 0 &&
         logT <= logB && batch < (1LL << 31) &&
         (batch << (logB - col_log(logA, logB))) < (1LL << 31);
}

// Shapes K8 covers: rows of B = 2..512 words, a grid within 2^31 blocks.
bool row_shape_ok(long long nrows, int logB) {
  return nrows > 0 && logB >= 1 && logB <= 9 && nrows < (1LL << 40) &&
         ((nrows + (1LL << (kLogRowTile - logB)) - 1) >> (kLogRowTile - logB)) <
             (1LL << 31);
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

// K7 in either direction, on a checked shape.
template <class F>
int col(int device, bool fwd, const uint64_t* x, uint64_t* y, long long batch, int logA,
        int logB, int logT, F f, int xnp, cudaStream_t st) {
  if (!col_shape_ok(batch, logA, logB, logT)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int logC = col_log(logA, logB), bytes = 8 << (logA + logC);
  const int grid = (int)(batch << (logB - logC));
  if (fwd) {
    if (int rc = fit_smem(col_fwd<F>, bytes)) return rc;
    col_fwd<F><<<grid, kThreads, bytes, st>>>(x, y, logA, logB, logC, f, logT, xnp);
  } else {
    if (int rc = fit_smem(col_inv<F>, bytes)) return rc;
    col_inv<F><<<grid, kThreads, bytes, st>>>(x, y, logA, logB, logC, f, logT, xnp);
  }
  return launch_status();
}

// K8 in either direction, on a checked shape.
template <class F>
int rows(int device, bool inverse, const uint64_t* x, uint64_t* y, long long nrows, int logB,
         F f, int xnp, cudaStream_t st) {
  if (!row_shape_ok(nrows, logB)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int log_rows = kLogRowTile - logB;
  const int grid = (int)((nrows + (1LL << log_rows) - 1) >> log_rows);
  if (inverse)
    row_mat<false, F><<<grid, kThreads, 0, st>>>(x, y, nrows, logB, f, xnp);
  else
    row_mat<true, F><<<grid, kThreads, 0, st>>>(x, y, nrows, logB, f, xnp);
  return launch_status();
}

// K7': the offset of shard `shard`'s first row of the (2^(logB_ring - logT),
// 2^logA) scale table, its slice 2^logB columns wide; -1 for a shard or a
// slice narrower than a tile, which the entries refuse.
long long shard_offset(long long shard, int logA, int logB, int logT) {
  if (shard < 0 || shard >= (1LL << 31) || logA < 0 || logT < 0 || logT > logB) return -1;
  return shard << (logB - logT + logA);
}

// An RNS schedule of `entries` moduli for `rings` rings, 2^shift each.
bool schedule_ok(long long rings, long long entries, int shift) {
  return shift >= 0 && shift < 31 && entries > 0 && (entries << shift) == rings;
}

// The column kernels' stacked tables: the A-point column table (A entries
// for X^N + 1, A / 2 for X^N - 1), the (A, T) tile and (B / T, A) scale
// tables of the twist, each with its Shoup companion.
Stacked col_tables(const int* mod_idx, int logA, int logB, int logT, const uint64_t* tw,
                   const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                   const uint64_t* ws, const uint64_t* wss, const uint64_t* consts,
                   int xnp) {
  return Stacked{mod_idx, 0,
                 Ring{tw, tws, wt, wts, ws, wss, 0, 0, 0, 0, 0, 0},
                 xnp ? 1LL << logA : 1LL << (logA - 1), 1LL << (logA + logT),
                 1LL << (logA + logB - logT), consts};
}

}  // namespace
}  // namespace merge_u64_large

using namespace merge_u64_large;

// Every entry: pointers to contiguous u64 words on card `device` (x and y
// must not overlap), launches on `stream`, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launch (0 = none).
// The column entries take (batch, 2^logA, 2^logB) rings, the column
// plan's bit-reversed table (A entries for X^N + 1, A / 2 for X^N - 1)
// with its Shoup companion, and the W tile (2^logA, 2^logT) and scale
// (2^(logB - logT), 2^logA) tables with theirs.  The row entry takes
// (nrows, 2^logB) rows and the row plan's table.  The rns_* entries (K13)
// take the same shapes with an int32 schedule (ring i uses modulus
// mod_idx[i], every entry in [0, mod_count); the row entry's ring is row
// >> shift), those tables stacked on a leading (mod_count,) axis, and the
// (mod_count, 6) constants of the stacked column or row plan.
extern "C" {

int merge_u64_large_colfwd(int device, const uint64_t* x, uint64_t* y, long long batch,
                           int logA, int logB, const uint64_t* tw, const uint64_t* tws,
                           const uint64_t* wt, const uint64_t* wts, const uint64_t* ws,
                           const uint64_t* wss, int logT, uint64_t q, uint64_t one_s,
                           int xnp, void* stream) {
  OneModulus f = one_modulus(tw, tws, q, one_s);
  f.r.wt = wt, f.r.wts = wts, f.r.ws = ws, f.r.wss = wss;
  return col(device, true, x, y, batch, logA, logB, logT, f, xnp, (cudaStream_t)stream);
}

int merge_u64_large_colinv(int device, const uint64_t* x, uint64_t* y, long long batch,
                           int logA, int logB, const uint64_t* tw, const uint64_t* tws,
                           const uint64_t* wt, const uint64_t* wts, const uint64_t* ws,
                           const uint64_t* wss, int logT, uint64_t q, uint64_t one_s,
                           uint64_t c_inv, uint64_t c_inv_s, int xnp, void* stream) {
  OneModulus f = one_modulus(tw, tws, q, one_s, c_inv, c_inv_s);
  f.r.wt = wt, f.r.wts = wts, f.r.ws = ws, f.r.wss = wss;
  return col(device, false, x, y, batch, logA, logB, logT, f, xnp, (cudaStream_t)stream);
}

// K7': the column entries on shard `shard` of a ring whose (batch, 2^logA,
// 2^logB) slices x and y hold that shard's 2^logB columns; ws and wss are
// the whole ring's scale tables, of which the shard's 2^(logB - logT) rows
// are read.
int merge_u64_large_colfwd_local(int device, const uint64_t* x, uint64_t* y,
                                 long long batch, int logA, int logB, long long shard,
                                 const uint64_t* tw, const uint64_t* tws, const uint64_t* wt,
                                 const uint64_t* wts, const uint64_t* ws, const uint64_t* wss,
                                 int logT, uint64_t q, uint64_t one_s, int xnp, void* stream) {
  const long long off = shard_offset(shard, logA, logB, logT);
  if (off < 0) return (int)cudaErrorInvalidValue;
  return merge_u64_large_colfwd(device, x, y, batch, logA, logB, tw, tws, wt, wts, ws + off,
                                wss + off, logT, q, one_s, xnp, stream);
}

int merge_u64_large_colinv_local(int device, const uint64_t* x, uint64_t* y,
                                 long long batch, int logA, int logB, long long shard,
                                 const uint64_t* tw, const uint64_t* tws, const uint64_t* wt,
                                 const uint64_t* wts, const uint64_t* ws, const uint64_t* wss,
                                 int logT, uint64_t q, uint64_t one_s, uint64_t c_inv,
                                 uint64_t c_inv_s, int xnp, void* stream) {
  const long long off = shard_offset(shard, logA, logB, logT);
  if (off < 0) return (int)cudaErrorInvalidValue;
  return merge_u64_large_colinv(device, x, y, batch, logA, logB, tw, tws, wt, wts, ws + off,
                                wss + off, logT, q, one_s, c_inv, c_inv_s, xnp, stream);
}

int merge_u64_large_rowmat(int device, const uint64_t* x, uint64_t* y, long long nrows,
                           int logB, const uint64_t* tw, const uint64_t* tws, uint64_t q,
                           uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s, int inverse,
                           int xnp, void* stream) {
  return rows(device, inverse, x, y, nrows, logB, one_modulus(tw, tws, q, one_s, n_inv, n_inv_s),
              xnp, (cudaStream_t)stream);
}

int rns_u64_large_colfwd(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int logA, int logB, const int* mod_idx, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, int logT,
                         const uint64_t* consts, int xnp, void* stream) {
  return col(device, true, x, y, batch, logA, logB, logT,
             col_tables(mod_idx, logA, logB, logT, tw, tws, wt, wts, ws, wss, consts, xnp),
             xnp, (cudaStream_t)stream);
}

int rns_u64_large_colinv(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int logA, int logB, const int* mod_idx, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, int logT,
                         const uint64_t* consts, int xnp, void* stream) {
  return col(device, false, x, y, batch, logA, logB, logT,
             col_tables(mod_idx, logA, logB, logT, tw, tws, wt, wts, ws, wss, consts, xnp),
             xnp, (cudaStream_t)stream);
}

int rns_u64_large_rowmat(int device, const uint64_t* x, uint64_t* y, long long nrows,
                         int logB, const int* mod_idx, long long entries, int shift,
                         const uint64_t* tw, const uint64_t* tws, const uint64_t* consts,
                         int inverse, int xnp, void* stream) {
  // a block's rows must lie in one ring: 2^(kLogRowTile - logB) <= 2^shift
  if (!schedule_ok(nrows, entries, shift) || kLogRowTile - logB > shift)
    return (int)cudaErrorInvalidValue;
  return rows(device, inverse, x, y, nrows, logB,
              stacked(mod_idx, shift, tw, tws, xnp ? 1LL << logB : 1LL << (logB - 1), consts),
              xnp, (cudaStream_t)stream);
}

}  // extern "C"
