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
// Bound: at u64 2^16 x 128 a transform must read and write the batch
// once, 128 MiB (0.040 ms at 3.35 TB/s); the two launches move it twice,
// and W (1 MiB of table and companion) is read by every ring, which L2
// holds.  Its 2^26 butterflies and 2^23 W products are each a 64-bit
// Shoup product of some 13 32-bit multiply-adds on the SM's 64-lane
// integer pipe, with the butterflies' adds, selects and addresses: as
// long as the bytes or longer.  So the kernels spend as few
// instructions a word as they can, as K1 and K7 do (merge_u64.cu,
// merge_u64_large.cu):
//   - Register passes (radix.cuh): an item of 8 words in one thread's
//     registers runs 3 stages with its index arithmetic and heap index
//     done once; a barrier between two passes, none a stage.
//   - Column launches take the log A stages in runs of at most 9
//     (kMaxRun: 3 radix-8 passes, 2 barriers), as even as they come: one
//     run up to log A = 9 (logn 16), two from logn 17 on; a run of L
//     stages is an instance of its own (L = 5-9), so its pass split is a
//     constant.  A block takes 2^L rows of C = 2^(13 - L) adjacent
//     columns of one ring, at most 128 (16 at L = 9: a tile of 2^13
//     words whatever the run, so that a pass has 256 items or more; the
//     rows a run pairs share their top s0 and bottom bits).  An item is 8
//     words of one column and the lanes of a warp take adjacent columns
//     of the same rows (K7's ColPasses), so each access to x, y or the
//     tile is a run of adjacent words, needs no padding, and the warp's
//     twiddle is one broadcast.  Stage l of the run from s0,
//     group i, reads heap entry (G0 << l) + i with G0 = 2^s0 + hi for
//     X^N + 1 (hi without it for X^N - 1): radix.cuh's shifted heap index.
//   - The row launch runs the 128-point row NTT as passes of 3, 3 and 1
//     stages (stages 0-2, 3-5, 6 forward; 6-4, 3-1, 0 inverse: the full
//     passes read device memory, 8 words a thread in flight), an item 8
//     words of one row, R rows a block in a tile with one spare word
//     after every 8 (radix::padded, as K8's); every row reads the same 64
//     entries (group i of a stage reads entry i).
//   - No load or store pass of its own: the forward's first column pass
//     reduces any input word, the forward row launch's first pass takes
//     the W product as it loads, its last makes the words canonical; the
//     inverse row launch's first pass reduces on load and its last takes
//     W^-1 as it stores; the inverse's last column pass takes n^-1 as it
//     stores.  Every word stored to device memory is canonical.
//   - The whole-ring form (logn <= kLogTile) runs the same column and row
//     passes in one block over the ring's padded tile: forward, the
//     column passes from x, the row passes (the first taking W as it
//     reads the tile) to y; inverse, the row passes from x (the last
//     taking W^-1 as it writes the tile), the column passes to y.  W has
//     no barrier of its own.
//   - Twiddles: each launch's first pass reads the plan's tables (L2
//     holds them), the passes after it a copy staged once a block in
//     shared memory (the run's 2^L - 1 column entries, local heap index
//     2^l + i, or the 64 row entries).  W is read through the read-only
//     path from the plan's interleaved copy, one load a word: an (entry,
//     companion) pair of 16 bytes (u64) or one packed 8-byte word (u32;
//     KernelMergePlan.w_kernel).
// Value policies, picked from q once a call by the host code (the
// entries below); the passes are the same template either way:
//   - u32 (q < 2^30, which the wrapper requires): merge_u32::Lazy, Harvey's
//     lazy butterflies, values below 4q < 2^32 inside a launch.
//   - u64, q < 2^62 (kLazyQ64): U64Lazy, merge_u64::Lazy64's butterflies,
//     values below 4q < 2^64.
//   - u64, q in [2^62, 2^63): 4q no longer fits the word, so U64Canon runs
//     the same passes with canonical butterflies (add_mod, sub_mod and
//     the canonical Shoup product of merge_u64.cuh, every sum below
//     2q < 2^64): exact for every q < 2^63, which the route takes.
// Tiles and occupancy: column tiles of 2^13 words (u64 64 KiB and its
// twiddles, 3 blocks an SM, 80 registers a thread; u32 32 KiB, 4 blocks,
// 64 registers); rows R = 32 a block (36 KiB padded u64, 18 KiB u32, 4
// blocks, 64 registers); the whole-ring form up to 2^14 words, both word
// sizes (144 KiB padded u64: 1 block an SM at 2^14, 3 below; 80
// registers).  256 threads a block; no instance spills.
// Measured against the alternatives (PERF.md section 6, kernel_bench.py
// variants): W as two tables (entry, companion) took up to 4% longer u64
// and 2-11% u32; 16 columns a block at every run length (half the threads
// idle at L = 6) 13-22% longer at 2^20 x 16; a column tile of 2^12 words
// (u64 at 4 blocks an SM) 2-4% shorter at u64 2^20 x 16 but up to 2%
// longer at u64 2^16 x 128 and up to 10% on u32; rows of 16 a block no
// faster, of 64 up to 17% slower; one block a ring at u32 2^15 17-20%
// slower than the two launches, at 2^14 within the noise of them.
// Tensor cores, TMA and clusters are not used: the work is 64- and
// 32-bit integer arithmetic, which tensor cores do not do.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u32.cuh"
#include "merge_u64_large.cuh"
#include "radix.cuh"

namespace kmerge {
namespace {

using merge_u64::Twiddle;

constexpr int kThreads = 256;
constexpr int kLogRow = 7;   // the 128-word rows (the TPU's lane width)
constexpr int kRadix = 3;    // radix-8 passes
constexpr int kMaxRun = 9;   // most column stages a column launch runs (3 passes)
constexpr int kPad = 3;      // one spare row-tile word after every 2^kPad
constexpr int kRowTw = 64;   // entries of the row table
// u64 moduli below this run the lazy instance: its values stay below 4q
constexpr uint64_t kLazyQ64 = 1ULL << 62;

// log2 words of the largest whole-ring tile (128 KiB u64, 64 KiB u32,
// before padding), of a column block's tile and of the rows of a row
// block; the blocks an SM each kernel is compiled for (a column block
// holds 64 KiB u64 or 32 KiB u32 and its twiddles).
constexpr int kLogTile = 14;
constexpr int kLogColTile = 13;
constexpr int kLogRows = 5;
template <class T>
constexpr int kColBlocks = sizeof(T) == 8 ? 3 : 4;
constexpr int kRowBlocks = 4;
constexpr int kWholeBlocks = 3;
constexpr int kWholeLogA = kLogTile - kLogRow;  // the whole form's largest log A

// log2 columns of a column block for a run of L stages: the tile's
// 2^kLogColTile words, at most whole rows (C = 16 at L = 9, 64 at 7, 128
// from 6 down), so that a pass has 256 items or more.
__host__ __device__ constexpr int col_log(int L) {
  return kLogColTile - L < kLogRow ? kLogColTile - L : kLogRow;
}

// i in a tile with one spare word after every 2^k (k = 0: no padding),
// and word kk of an item whose words lie S apart (radix::padded_step).
template <int k>
__device__ __forceinline__ int pad(int i) {
  return k ? radix::padded<k>(i) : i;
}
template <int k>
__device__ __forceinline__ int pad_step(int kk, int S) {
  return k ? radix::padded_step<k>(kk, S) : kk * S;
}

// The three value policies: the word T, the twiddle Tw (an entry with
// its Shoup companion), the butterflies (ct, gs: radix::network's Ar),
// and what a launch does to words at its edges:
//   reduce(x)       any input word, into the butterflies' input range;
//   mul(x, t)       x times a W entry, lazy where the policy is (any x);
//   mul_canon(x, t) the same, canonical;
//   canon(x)        a butterfly output, canonical;
//   scale(x)        x times n^-1, canonical (any x).
struct U32Lazy : merge_u32::Lazy {
  using T = uint32_t;
  using Tw = uint64_t;  // w low, its companion high (merge_u32.cuh)
  uint32_t one_s, n_inv, n_inv_s;
  static __device__ __forceinline__ Tw tw(const uint64_t* w, const uint64_t* ws, int i) {
    return __ldg(w + i) | (__ldg(ws + i) << 32);
  }
  // a packed word of W's kernel layout (entry low, companion high)
  static __device__ __forceinline__ Tw wtw(const uint64_t* w, int i) { return __ldg(w + i); }
  __device__ __forceinline__ T reduce(uint64_t x) const {
    return merge_u32::shoup_mul_lazy((uint32_t)x, 1u, one_s, q);
  }
  __device__ __forceinline__ T mul(T x, Tw t) const {
    return merge_u32::shoup_mul_lazy(x, (uint32_t)t, (uint32_t)(t >> 32), q);
  }
  __device__ __forceinline__ T mul_canon(T x, Tw t) const {
    return merge_u32::shoup_mul(x, (uint32_t)t, (uint32_t)(t >> 32), q);
  }
  __device__ __forceinline__ T scale(T x) const {
    return merge_u32::shoup_mul(x, n_inv, n_inv_s, q);
  }
};

struct U64Lazy : merge_u64::Lazy64 {
  using T = uint64_t;
  using Tw = Twiddle;
  uint64_t one_s, n_inv, n_inv_s;
  static __device__ __forceinline__ Tw tw(const uint64_t* w, const uint64_t* ws, int i) {
    return Twiddle{__ldg(w + i), __ldg(ws + i)};
  }
  // an (entry, companion) pair of W's kernel layout, one 16-byte load
  static __device__ __forceinline__ Tw wtw(const uint64_t* w, int i) {
    const ulonglong2 u = __ldg(reinterpret_cast<const ulonglong2*>(w) + i);
    return Twiddle{u.x, u.y};
  }
  __device__ __forceinline__ T reduce(uint64_t x) const {
    return merge_u64::shoup_mul_lazy(x, 1, one_s, q);
  }
  __device__ __forceinline__ T mul(T x, Tw t) const {
    return merge_u64::shoup_mul_lazy(x, t.w, t.ws, q);
  }
  __device__ __forceinline__ T mul_canon(T x, Tw t) const {
    return merge_u64::shoup_mul(x, t.w, t.ws, q);
  }
  __device__ __forceinline__ T canon(T x) const {  // [0, 4q) -> [0, q)
    const uint64_t u = x >= q2 ? x - q2 : x;
    return u >= q ? u - q : u;
  }
  __device__ __forceinline__ T scale(T x) const {
    return merge_u64::shoup_mul(x, n_inv, n_inv_s, q);
  }
};

// q in [2^62, 2^63): canonical butterflies, every value below q.
struct U64Canon {
  using T = uint64_t;
  using Tw = Twiddle;
  uint64_t q, one_s, n_inv, n_inv_s;
  static __device__ __forceinline__ Tw tw(const uint64_t* w, const uint64_t* ws, int i) {
    return U64Lazy::tw(w, ws, i);
  }
  static __device__ __forceinline__ Tw wtw(const uint64_t* w, int i) { return U64Lazy::wtw(w, i); }
  __device__ __forceinline__ void ct(uint64_t& x, uint64_t& y, const Twiddle& t) const {
    const uint64_t u = x, v = merge_u64::shoup_mul(y, t.w, t.ws, q);
    x = merge_u64::add_mod(u, v, q);
    y = merge_u64::sub_mod(u, v, q);
  }
  __device__ __forceinline__ void gs(uint64_t& x, uint64_t& y, const Twiddle& t) const {
    const uint64_t u = x, v = y;
    x = merge_u64::add_mod(u, v, q);
    y = merge_u64::shoup_mul(merge_u64::sub_mod(u, v, q), t.w, t.ws, q);
  }
  __device__ __forceinline__ T reduce(uint64_t x) const {
    return merge_u64::reduce_any(x, q, one_s);
  }
  __device__ __forceinline__ T mul(T x, Tw t) const { return mul_canon(x, t); }
  __device__ __forceinline__ T mul_canon(T x, Tw t) const {
    return merge_u64::shoup_mul(x, t.w, t.ws, q);
  }
  __device__ __forceinline__ T canon(T x) const { return x; }
  __device__ __forceinline__ T scale(T x) const {
    return merge_u64::shoup_mul(x, n_inv, n_inv_s, q);
  }
};

// The tables of one direction (int64 words holding the values), each
// with its Shoup companion: the column prefix (2A entries for X^N + 1, A
// for X^N - 1), the (A, 128) W with its companion interleaved (u64: an
// (entry, companion) pair a position; u32: entry | companion << 32), the
// 64-entry row table.
struct Tables {
  const uint64_t* col;
  const uint64_t* cols;
  const uint64_t* w;
  const uint64_t* row;
  const uint64_t* rows;
};

// Twiddles of a pass (radix::network's Tw): a plan's table and its
// companion, or a block's staged copy.
template <class P>
struct TableTw {
  const uint64_t* w;
  const uint64_t* ws;
  __device__ __forceinline__ typename P::Tw operator()(int i) const { return P::tw(w, ws, i); }
};
template <class P>
struct StagedTw {
  const typename P::Tw* t;
  __device__ __forceinline__ typename P::Tw operator()(int i) const { return t[i]; }
};

// Stage the entries that the L column stages of a run read, heap entry
// (g0 << l) + i of stage l at local heap index 2^l + i (read after the
// block's first barrier).
template <class P>
__device__ __forceinline__ void stage_cols(typename P::Tw* s, const Tables& t, int g0, int L) {
  for (int l = 0; l < L; ++l)
    for (int i = threadIdx.x; i < (1 << l); i += kThreads)
      s[(1 << l) + i] = P::tw(t.col, t.cols, (g0 << l) + i);
}

template <class P>
__device__ __forceinline__ void stage_row(typename P::Tw* s, const Tables& t) {
  for (int i = threadIdx.x; i < kRowTw; i += kThreads) s[i] = P::tw(t.row, t.rows, i);
}

// The column passes of a block (radix::passes): a (2^L, C) tile of C =
// 2^logC adjacent columns, L stages of the network from stage s0.  Item
// k of a pass of 2^kR words from local stage l0 holds tile rows m + kk S
// of column c = k mod C; tile row m lies `rs` device words after the
// previous one, from x and y (the block's first word), at tile word
// pad(m C + c).  The first pass reads x when kFromDev (forward: reduced
// where `reduce`), the tile otherwise; the last writes y when kToDev
// (canonical; inverse: times n^-1 where `scale`), the tile otherwise.
// Twiddles: the table (global heap index (g0 << l0) + i0) for a pass that
// reads x, the staged copy (local heap index 2^l0 + i0) for the others.
template <class P, bool kFwd, int kTilePad, bool kFromDev, bool kToDev>
struct ColPasses {
  using T = typename P::T;
  int L, logC, g0;
  size_t rs;
  T* s;
  const uint64_t* x;
  uint64_t* y;
  int reduce, scale;
  Tables t;
  const typename P::Tw* stw;
  P pol;

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR;
    constexpr bool kDevIn = kIn && kFromDev, kDevOut = kOut && kToDev;
    const int logS = L - l0 - kR;
    for (int k = threadIdx.x; k < (1 << (L - kR + logC)); k += kThreads) {
      const int c = k & ((1 << logC) - 1), w = k >> logC, i0 = w >> logS;
      const int m = (i0 << (L - l0)) + (w & ((1 << logS) - 1));
      const int tp = (m << logC) + c, ts = 1 << (logS + logC);
      const size_t g = m * rs + c, gs = rs << logS;
      T* tile = s + pad<kTilePad>(tp);
      T v[kN];
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kDevIn) {
          const uint64_t u = x[g + kk * gs];
          v[kk] = kFwd && reduce ? pol.reduce(u) : (T)u;
        } else {
          v[kk] = tile[pad_step<kTilePad>(kk, ts)];
        }
      }
      if constexpr (kDevIn)
        radix::network<kR, kFwd>(v, (g0 << l0) + i0, pol, TableTw<P>{t.col, t.cols});
      else
        radix::network<kR, kFwd>(v, (1 << l0) + i0, pol, StagedTw<P>{stw});
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kDevOut)
          y[g + kk * gs] = !kFwd && scale ? pol.scale(v[kk]) : pol.canon(v[kk]);
        else
          tile[pad_step<kTilePad>(kk, ts)] = v[kk];
      }
    }
  }
};

// The row passes of a block: `nrows` whole rows of 128 words, global rows
// r0 .. of the (batch * A, 128) view (W row (r0 + j) mod A), in a padded
// tile.  Item k of a pass of 2^kR words from stage l0 holds words p + kk
// S of the tile, row j = p / 128; group i0 reads row-table entry i0.  The
// forward's first pass takes the W product as it reads (x when kFromDev,
// else the tile), its last writes y canonically.  The inverse's first
// pass reads x, reduced; its last takes W^-1 as it writes, to y
// canonically when kToDev, lazily to the tile otherwise.  Twiddles: the
// table for a pass that reads x, the staged copy for the others.
template <class P, bool kFwd, bool kFromDev, bool kToDev>
struct RowPasses {
  using T = typename P::T;
  int nrows, r0, amask;
  T* s;
  const uint64_t* x;
  uint64_t* y;
  Tables t;
  const typename P::Tw* stw;
  P pol;

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR, kLw = kLogRow - kR;
    constexpr bool kDevIn = kIn && kFromDev, kDevOut = kOut && kToDev;
    const int logT = kLogRow - l0 - kR, St = 1 << logT;
    for (int k = threadIdx.x; k < (nrows << kLw); k += kThreads) {
      const int j = k >> kLw, w = k & ((1 << kLw) - 1), i0 = w >> logT;
      const int p = (j << kLogRow) + (i0 << (kLogRow - l0)) + (w & (St - 1));
      // W's entry for word 0 of the item
      const int we = (((r0 + j) & amask) << kLogRow) + (p & ((1 << kLogRow) - 1));
      T* tile = s + radix::padded<kPad>(p);
      T v[kN];
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kDevIn) {
          const uint64_t u = x[p + kk * St];
          v[kk] = kFwd ? pol.mul((T)u, P::wtw(t.w, we + kk * St)) : pol.reduce(u);
        } else {
          const T u = tile[radix::padded_step<kPad>(kk, St)];
          v[kk] = kFwd && kIn ? pol.mul(u, P::wtw(t.w, we + kk * St)) : u;
        }
      }
      if constexpr (kDevIn)
        radix::network<kR, kFwd>(v, i0, pol, TableTw<P>{t.row, t.rows});
      else
        radix::network<kR, kFwd>(v, i0, pol, StagedTw<P>{stw});
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kDevOut && kFwd) {
          y[p + kk * St] = pol.canon(v[kk]);
        } else if (kDevOut) {
          y[p + kk * St] = pol.mul_canon(v[kk], P::wtw(t.w, we + kk * St));
        } else {
          tile[radix::padded_step<kPad>(kk, St)] =
              !kFwd && kOut ? pol.mul(v[kk], P::wtw(t.w, we + kk * St)) : v[kk];
        }
      }
    }
  }
};

// The 7 row stages as passes of 3, 3 and 1 (stages 0-2, 3-5, 6 forward;
// 6-4, 3-1, 0 inverse), a barrier between two.
template <bool kFwd, class R>
__device__ __forceinline__ void row_passes(const R& p) {
  p.template run<kRadix, true, false>(kFwd ? 0 : 4);
  __syncthreads();
  p.template run<kRadix, false, false>(kFwd ? 3 : 1);
  __syncthreads();
  p.template run<1, false, true>(kFwd ? 6 : 0);
}

// One block per ring: the whole padded (A, 128) tile.  x may equal y.
// logn 7 (A = 1) has no column stages: its forward copies x into the
// tile first, its inverse scales the tile out last.
template <class P, bool kFwd>
__global__ void __launch_bounds__(kThreads, kWholeBlocks)
whole(const uint64_t* x, uint64_t* y, int logn, Tables t, P pol, int xnp) {
  using T = typename P::T;
  extern __shared__ uint64_t smem[];
  __shared__ typename P::Tw cstw[1 << kWholeLogA];
  __shared__ typename P::Tw rstw[kRowTw];
  T* s = reinterpret_cast<T*>(smem);
  const int logA = logn - kLogRow;
  const size_t off = (size_t)blockIdx.x << logn;
  stage_cols<P>(cstw, t, xnp, logA);
  stage_row<P>(rstw, t);
  const ColPasses<P, kFwd, kPad, kFwd, !kFwd> cp{
      logA, kLogRow, xnp, (size_t)1 << kLogRow, s, x + off, y + off, 1, 1, t, cstw, pol};
  const RowPasses<P, kFwd, !kFwd, kFwd> rp{1 << logA, 0, (1 << logA) - 1, s, x + off,
                                           y + off, t, rstw, pol};
  if constexpr (kFwd) {
    if (logA > 0)
      radix::passes<kRadix, true>(logA, cp);
    else
      for (int e = threadIdx.x; e < (1 << logn); e += kThreads)
        s[radix::padded<kPad>(e)] = (T)x[off + e];
    __syncthreads();
    row_passes<true>(rp);
  } else {
    row_passes<false>(rp);
    __syncthreads();
    if (logA > 0)
      radix::passes<kRadix, false>(logA, cp);
    else
      for (int e = threadIdx.x; e < (1 << logn); e += kThreads)
        y[off + e] = pol.scale(s[radix::padded<kPad>(e)]);
  }
}

// A run of kL column stages from s0 of the (A, 128) view.  Block = (ring,
// hi, lo, column tile): tile rows ((hi << kL) + m) << lo_log | lo, m <
// 2^kL, of C adjacent columns.  Forward: reduce on load (`reduce`, the
// first run), CT stages.  Inverse: GS stages, n^-1 on store (`scale`,
// the last run).  x may equal y.
template <class P, bool kFwd, int kL>
__global__ void __launch_bounds__(kThreads, kColBlocks<typename P::T>)
cols(const uint64_t* x, uint64_t* y, int logn, int s0, Tables t, P pol, int reduce, int scale,
     int xnp) {
  using T = typename P::T;
  constexpr int kLogC = col_log(kL);
  extern __shared__ uint64_t smem[];
  __shared__ typename P::Tw stw[1 << kL];
  const int logA = logn - kLogRow, lo_log = logA - s0 - kL;
  size_t b = blockIdx.x;
  const int ctile = (int)(b & ((1u << (kLogRow - kLogC)) - 1));
  b >>= kLogRow - kLogC;
  const size_t lo = b & (((size_t)1 << lo_log) - 1);
  b >>= lo_log;
  const int hi = (int)(b & ((1u << s0) - 1));
  const size_t ring = b >> s0;
  const size_t off = (ring << logn) + ((((size_t)hi << (kL + lo_log)) | lo) << kLogRow) +
                     ((size_t)ctile << kLogC);
  const int g0 = (xnp << s0) + hi;
  stage_cols<P>(stw, t, g0, kL);
  radix::passes<kRadix, kFwd>(
      kL, ColPasses<P, kFwd, 0, true, true>{kL, kLogC, g0, (size_t)1 << (lo_log + kLogRow),
                                            reinterpret_cast<T*>(smem), x + off, y + off,
                                            reduce, scale, t, stw, pol});
}

// Row launch: R consecutive 128-word rows of the (batch * A, 128) view,
// the last block possibly short.  Forward: W on load, the row NTT.
// Inverse: reduce on load, the row inverse, W^-1 on store.  x may equal y.
template <class P, bool kFwd>
__global__ void __launch_bounds__(kThreads, kRowBlocks)
rows(const uint64_t* x, uint64_t* y, long long total_rows, int logA, Tables t, P pol) {
  using T = typename P::T;
  extern __shared__ uint64_t smem[];
  __shared__ typename P::Tw rstw[kRowTw];
  const long long r0 = (long long)blockIdx.x << kLogRows;
  const long long left = total_rows - r0;
  const int nrows = left < (1LL << kLogRows) ? (int)left : 1 << kLogRows;
  const size_t off = (size_t)r0 << kLogRow;
  stage_row<P>(rstw, t);
  row_passes<kFwd>(RowPasses<P, kFwd, true, true>{nrows, (int)r0, (1 << logA) - 1,
                                                   reinterpret_cast<T*>(smem), x + off, y + off,
                                                   t, rstw, pol});
}

// Words of a padded tile of 2^logw words.
int padded_words(int logw) { return (1 << logw) + ((1 << logw) >> kPad); }

// Shapes the kernels take: logn 7-25, every grid size and row index an
// int.
bool shape_ok(long long batch, int logn) {
  if (batch <= 0 || logn < kLogRow || logn > 25) return false;
  return batch < (1LL << 31) && (batch << (logn - 4)) < (1LL << 31);
}

// Allow `bytes` of dynamic shared memory for `kernel` beside its
// `fixed` bytes of static shared memory (needed past 48 KB in all).
template <class K>
int fit_smem(K kernel, int bytes, int fixed) {
  if (bytes + fixed <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

int launch_status() {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e;
}

// One whole-ring launch (logn <= kLogTile).
template <class P, bool kFwd>
int run_whole(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
              const P& pol, int xnp, cudaStream_t st) {
  const int bytes = (int)sizeof(typename P::T) * padded_words(logn);
  const int fixed = (int)sizeof(typename P::Tw) * ((1 << kWholeLogA) + kRowTw);
  if (int rc = fit_smem(whole<P, kFwd>, bytes, fixed)) return rc;
  whole<P, kFwd><<<(int)batch, kThreads, bytes, st>>>(x, y, logn, t, pol, xnp);
  return launch_status();
}

// The column kernel of a run of L stages, or null: runs are 5-9 stages
// long (log A = 10 takes two of 5; kLogTile keeps log A >= 5 here).
template <class P, bool kFwd>
auto col_kernel(int L) {
  switch (L) {
    case 5: return cols<P, kFwd, 5>;
    case 6: return cols<P, kFwd, 6>;
    case 7: return cols<P, kFwd, 7>;
    case 8: return cols<P, kFwd, 8>;
    case 9: return cols<P, kFwd, 9>;
  }
  return static_cast<decltype(&cols<P, kFwd, 9>)>(nullptr);
}

// The column launches: the log A stages in runs of at most kMaxRun, as
// even as they come; forward in ascending order from x (reduced on load),
// inverse in descending order in place (n^-1 on the last store).
template <class P, bool kFwd>
int run_cols(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
             const P& pol, int xnp, cudaStream_t st) {
  using T = typename P::T;
  const int logA = logn - kLogRow;
  const int runs = (logA + kMaxRun - 1) / kMaxRun;
  int bounds[4];
  bounds[0] = 0;
  for (int p = 0; p < runs; ++p) bounds[p + 1] = bounds[p] + (logA - bounds[p]) / (runs - p);
  for (int j = 0; j < runs; ++j) {
    const int p = kFwd ? j : runs - 1 - j;
    const int s0 = bounds[p], L = bounds[p + 1] - bounds[p];
    const auto k = col_kernel<P, kFwd>(L);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    const int bytes = (int)sizeof(T) << (L + col_log(L));
    if (int rc = fit_smem(k, bytes, (int)sizeof(typename P::Tw) << L)) return rc;
    k<<<(int)(batch << (logA - L + kLogRow - col_log(L))), kThreads, bytes, st>>>(
        j == 0 ? x : y, y, logn, s0, t, pol, kFwd && j == 0, !kFwd && j == runs - 1, xnp);
    if (int rc = launch_status()) return rc;
  }
  return 0;
}

// The row launch.
template <class P, bool kFwd>
int run_rows(const uint64_t* x, uint64_t* y, long long batch, int logn, const Tables& t,
             const P& pol, cudaStream_t st) {
  using T = typename P::T;
  const int logA = logn - kLogRow;
  const long long total = batch << logA;
  const int bytes = (int)sizeof(T) * padded_words(kLogRows + kLogRow);
  if (int rc = fit_smem(rows<P, kFwd>, bytes, (int)sizeof(typename P::Tw) * kRowTw)) return rc;
  rows<P, kFwd><<<(int)((total + (1LL << kLogRows) - 1) >> kLogRows), kThreads, bytes, st>>>(
      x, y, total, logA, t, pol);
  return launch_status();
}

template <class P>
int forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
            const Tables& t, const P& pol, int xnp, cudaStream_t st) {
  if (!shape_ok(batch, logn)) return (int)cudaErrorInvalidValue;
  if (int rc = (int)cudaSetDevice(device)) return rc;
  if (logn <= kLogTile) return run_whole<P, true>(x, y, batch, logn, t, pol, xnp, st);
  if (int rc = run_cols<P, true>(x, y, batch, logn, t, pol, xnp, st)) return rc;
  return run_rows<P, true>(y, y, batch, logn, t, pol, st);
}

template <class P>
int inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
            const Tables& t, const P& pol, int xnp, cudaStream_t st) {
  if (!shape_ok(batch, logn)) return (int)cudaErrorInvalidValue;
  if (int rc = (int)cudaSetDevice(device)) return rc;
  if (logn <= kLogTile) return run_whole<P, false>(x, y, batch, logn, t, pol, xnp, st);
  if (int rc = run_rows<P, false>(x, y, batch, logn, t, pol, st)) return rc;
  return run_cols<P, false>(y, y, batch, logn, t, pol, xnp, st);
}

U32Lazy lazy32(uint32_t q, uint32_t one_s, uint32_t n_inv, uint32_t n_inv_s) {
  return U32Lazy{{q, 2 * q}, one_s, n_inv, n_inv_s};
}

U64Lazy lazy64(uint64_t q, uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s) {
  return U64Lazy{{q, 2 * q}, one_s, n_inv, n_inv_s};
}

}  // namespace
}  // namespace kmerge

using namespace kmerge;

// Every entry: pointers to contiguous (batch, 2^logn) int64 lanes on card
// `device` (u64 bit patterns, or u32 values of which the low 32 bits are
// read), the direction's tables as int64 words with their companions
// (KernelMergePlan.tables), q and floor(2^word / q), for the inverse n^-1
// and its companion; logn 7-25.  The u64 entries run the lazy instance
// for q < 2^62 and the canonical one for q in [2^62, 2^63).
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns the cudaError_t of its launches (0 = none).  x may equal y.
extern "C" {

int kmerge_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* row, const uint64_t* rows,
                       uint64_t q, uint64_t one_s, int xnp, void* stream) {
  const Tables t{col, cols, w, row, rows};
  if (q < kLazyQ64)
    return forward(device, x, y, batch, logn, t, lazy64(q, one_s, 0, 0), xnp,
                   (cudaStream_t)stream);
  return forward(device, x, y, batch, logn, t, U64Canon{q, one_s, 0, 0}, xnp,
                 (cudaStream_t)stream);
}

int kmerge_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* row, const uint64_t* rows,
                       uint64_t q, uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s,
                       int xnp, void* stream) {
  const Tables t{col, cols, w, row, rows};
  if (q < kLazyQ64)
    return inverse(device, x, y, batch, logn, t, lazy64(q, one_s, n_inv, n_inv_s), xnp,
                   (cudaStream_t)stream);
  return inverse(device, x, y, batch, logn, t, U64Canon{q, one_s, n_inv, n_inv_s}, xnp,
                 (cudaStream_t)stream);
}

int kmerge_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* row, const uint64_t* rows,
                       uint32_t q, uint32_t one_s, int xnp, void* stream) {
  return forward(device, x, y, batch, logn, Tables{col, cols, w, row, rows},
                 lazy32(q, one_s, 0, 0), xnp, (cudaStream_t)stream);
}

int kmerge_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                       const uint64_t* col, const uint64_t* cols, const uint64_t* w,
                       const uint64_t* row, const uint64_t* rows,
                       uint32_t q, uint32_t one_s, uint32_t n_inv, uint32_t n_inv_s,
                       int xnp, void* stream) {
  return inverse(device, x, y, batch, logn, Tables{col, cols, w, row, rows},
                 lazy32(q, one_s, n_inv, n_inv_s), xnp, (cudaStream_t)stream);
}

}  // extern "C"
