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
// A = 512, 32 at A = 256, 64 at A = 128.
//
// Bound: each launch reads and writes its operand once; at 2^24 x 1
// that is 256 MiB, 0.080 ms at 3.35 TB/s.  Its log A / 2 + 3 Shoup
// products per word (2^24 * 7 at 2^24, forward) cost some 13 32-bit
// multiply-adds each on the SM's 64-lane integer pipe: about as long as
// the bytes (0.08-0.10 ms at 1.75-1.98 GHz), and with the butterflies'
// adds, selects and addresses, longer.  So K7 spends as few
// instructions a word as it can, as K8 does (below):
//   - Register passes down the columns (radix.cuh, ColPasses): log A
//     stages as radix-8 passes (A = 256: 2 + 3 + 3 forward, 3 + 3 + 2
//     inverse), an item 8 words of one column, 2 barriers for 8 stages.
//     The lanes of a warp take adjacent columns of the same rows, so
//     each access to x, y or the tile is a run of adjacent words (256
//     bytes at C = 32), needs no padding against bank conflicts, and the
//     warp's twiddle is one broadcast.
//   - No load or store pass of its own: the first pass reads x (forward:
//     reduced below 2q; inverse: times W^-1 by two lazy Shoup products),
//     the last writes y (forward: times W, the tile product lazy and the
//     scale product canonical; inverse: times c_inv).
//   - The column table and its companion are copied to shared memory once
//     per block (8 KiB at A = 512) for the passes after the first.
//   - Lazy butterflies (Lazy64, q < 2^62, which the wrappers require).
//   - A = 128, 256 and 512 at the full tile, the route's shapes, run
//     instances compiled for them; 3 blocks an SM (72 KiB each), no spill.

// K8, whole rows: a block takes 4096 / B rows of B <= 512 words (36 KiB
// of static shared memory with its padding), the last block short when
// the rows do not fill it.  At 2^27 (2^18 rows of 512) its bytes take
// 0.64 ms; its 6.0e8 butterflies, each a 64-bit Shoup product of some
// 13 32-bit multiply-adds and as many adds and selects, keep the SM's
// integer pipes busy about as long (64 lanes an SM a clock).  A radix-2
// stage per pass over shared memory, with two 8-byte twiddle loads from
// device memory, the index arithmetic per butterfly and every sum made
// canonical, costs some 61 instructions a butterfly in sm_90a SASS; an
// item of the passes below about 33.  So K8 spends as few instructions
// a butterfly as it can:
//   - Register passes (radix.cuh): the log B stages run as radix-8
//     passes (3 of 3 stages at B = 512, the short one first forward and
//     last inverse), each item of 8 words in one thread's registers, with
//     its index arithmetic and heap index done once: 2 barriers for 9
//     stages.  The first pass reads x and the last writes y directly (at
//     a stride of B / 8 the lanes of a warp read adjacent words; 8
//     adjacent words of a thread move as 16-byte accesses where x or y is
//     16-byte aligned, checked once a block, and as 8-byte ones where a
//     caller's view starts at an odd word).  Rows of 512
//     words run a copy of the passes in which every stride and offset is
//     a constant, which spares the address arithmetic of each word.
//   - Twiddles: the B-entry table and its Shoup companion are copied to
//     shared memory once per block (8 KiB at B = 512) for the passes
//     after the first, one 16-byte load a twiddle.
//   - The tile has one spare word after every 8, which keeps each
//     half-warp's 8-byte words on distinct banks in the passes that read
//     and write it, with offsets that depend on the stride alone.
//   - Lazy (Harvey) butterflies (merge_u64_large.cuh, Lazy64): values
//     stay in [0, 4q) inside the launch, lazy Shoup products in [0, 2q);
//     inputs are reduced mod q on load, outputs made canonical (and
//     multiplied by n_inv, inverse) on store.  4q < 2^64 needs q < 2^62,
//     which the wrapper (hopper_merge_large.rowmat) requires of every
//     plan; the canonical kernels of merge_u64.cu do not need it.
//   - 64 registers a thread and 4 blocks an SM for the inverse, 80 and
//     3 for the forward, none spilled (__launch_bounds__).
// Tensor cores, TMA and clusters are not used: the work is 64-bit
// integer arithmetic, which tensor cores do not do.
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
#include "radix.cuh"


namespace merge_u64_large {
namespace {

using merge_u64::one_modulus;
using merge_u64::OneModulus;
using merge_u64::reduce_any;
using merge_u64::Ring;
using merge_u64::Stacked;
using merge_u64::stacked;
using merge_u64::shoup_mul;
using merge_u64::shoup_mul_lazy;
using merge_u64::Lazy64;
using merge_u64::Twiddle;
using merge_u64::GlobalTw;
using merge_u64::SharedTw;
using merge_u64::aligned16;

constexpr int kThreads = 256;
constexpr int kLogColTile = 13;  // K7 tile: 2^13 words (64 KiB)
constexpr int kMaxColLog = 9;    // K7 columns: at most 2^9 words
constexpr int kColRadix = 3;     // K7: log2 words of an item (radix-8 passes)
// K7: blocks an SM holds, 3 for the route's shapes (72 KiB of shared
// memory each, 80 registers a thread), 2 (128 registers) for the generic
// instance, whose pass radix is known only at run time; none spills
template <int kLogA>
constexpr int col_blocks() { return kLogA ? 3 : 2; }
constexpr int kLogRowTile = 12;  // K8 tile: 2^12 words (32 KiB, and its padding)
constexpr int kMaxRowLog = 9;    // K8 rows: at most 2^9 words
constexpr int kRowRadix = 3;     // K8: log2 words of an item (radix-8 passes)
constexpr int kRowPad = 3;       // K8: one spare tile word after every 2^kRowPad
// K8: blocks an SM holds, 64 registers a thread for the inverse; the
// forward, whose first pass reduces its input mod q, takes 80 (3 blocks)
// and so spills none
template <bool kFwd>
constexpr int row_blocks() { return kFwd ? 3 : 4; }

// K7's items: the C = 2^logC columns of an (A, C) tile, each the A-point
// network down its column.  Item k of a pass of 2^kR words from stage
// l0 holds rows row + kk S of column c = k mod C: the lanes of a warp
// take adjacent columns of the same rows, so that each of their
// accesses to x, y and the tile is a run of adjacent words (C = 32: 256
// bytes, with no bank conflict and no padding) and their twiddle is one
// broadcast.  Stage l, group i reads entry i, offset by 2^l for X^N + 1.
struct ColItem {
  int row, S, c, G;
};

struct ColGeo {
  int logA, logC, xnp;
  __device__ __forceinline__ int items(int r) const { return 1 << (logA - r + logC); }
  template <int kR>
  __device__ __forceinline__ ColItem item(int k, int l0) const {
    const int logS = logA - l0 - kR, w = k >> logC, i0 = w >> logS;
    return ColItem{(i0 << (logA - l0)) + (w & ((1 << logS) - 1)), 1 << logS,
                   k & ((1 << logC) - 1), (xnp << l0) + i0};
  }
};

// K7's passes over a block's tile (radix::passes).  The first reads x:
// forward, each word reduced below 2q; inverse, each word times W^-1
// (two lazy products, below 2q).  The last writes y canonically:
// forward, times W (the tile product lazy, the scale product
// canonical); inverse, times c_inv.  x and y point at the block's
// first column of its ring, whose rows lie B words apart.
template <bool kFwd>
struct ColPasses {
  ColGeo geo;
  int logB, logT, b0;
  uint64_t* s;
  const uint64_t* __restrict__ x;
  uint64_t* __restrict__ y;
  Ring f;
  Lazy64 ar;
  GlobalTw gtw;
  SharedTw tw;

  // v W[a, b0 + c]: the tile table's product lazy (any v, below 2q),
  // the scale table's canonical (kCanon) or lazy; table offsets below
  // A B <= 2^30 (col_shape_ok): 32-bit
  template <bool kCanon>
  __device__ __forceinline__ uint64_t twist(uint64_t v, int a, int c) const {
    const int b = b0 + c;
    const int t = (a << logT) + (b & ((1 << logT) - 1)), j = ((b >> logT) << geo.logA) + a;
    const uint64_t u = shoup_mul_lazy(v, __ldg(f.wt + t), __ldg(f.wts + t), f.q);
    return kCanon ? shoup_mul(u, __ldg(f.ws + j), __ldg(f.wss + j), f.q)
                  : shoup_mul_lazy(u, __ldg(f.ws + j), __ldg(f.wss + j), f.q);
  }

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR;
    const int items = geo.items(kR);
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const ColItem it = geo.item<kR>(k, l0);
      const size_t g0 = ((size_t)it.row << logB) + it.c, gs = (size_t)it.S << logB;
      uint64_t* t = s + (it.row << geo.logC) + it.c;
      const int ts = it.S << geo.logC;
      uint64_t v[kN];
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (!kIn)
          v[kk] = t[kk * ts];
        else if (kFwd)
          v[kk] = shoup_mul_lazy(x[g0 + kk * gs], 1, f.one_s, f.q);
        else
          v[kk] = twist<false>(x[g0 + kk * gs], it.row + kk * it.S, it.c);
      }
      if constexpr (kIn)
        radix::network<kR, kFwd>(v, it.G, ar, gtw);
      else
        radix::network<kR, kFwd>(v, it.G, ar, tw);
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (!kOut)
          t[kk * ts] = v[kk];
        else if (kFwd)
          y[g0 + kk * gs] = twist<true>(v[kk], it.row + kk * it.S, it.c);
        else
          y[g0 + kk * gs] = shoup_mul(v[kk], f.n_inv, f.n_inv_s, f.q);
      }
    }
  }
};

// K7: block = (ring, C columns); x -> y.  Forward: reduce, CT stages,
// twist by W.  Inverse: reduce and twist by W^-1, GS stages, then c_inv =
// f.n_inv (A^-1 for the standard scaling).  The column table and its
// companion are copied to shared memory for the passes after the first.
// kLogA: the column count the kernel is compiled for, with the full
// tile of 2^kLogColTile words, or 0 for any (logA, logC).
template <bool kFwd, class F, int kLogA>
__global__ void __launch_bounds__(kThreads, col_blocks<kLogA>())
col_mat(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int logA_, int logB,
        int logC_, F fs, int logT, int xnp) {
  extern __shared__ uint64_t smem[];
  __shared__ Twiddle stw[1 << kMaxColLog];
  const int logA = kLogA ? kLogA : logA_, logC = kLogA ? kLogColTile - kLogA : logC_;
  const size_t ring = blockIdx.x >> (logB - logC);
  const Ring f = fs.at(ring);
  const int b0 = (blockIdx.x & ((1 << (logB - logC)) - 1)) << logC;
  const size_t off = (ring << (logA + logB)) + b0;
  if (logA > kColRadix)  // read after the first barrier
    for (int e = threadIdx.x; e < (1 << (logA - 1 + xnp)); e += kThreads)
      stw[e] = Twiddle{__ldg(f.tw + e), __ldg(f.tws + e)};
  radix::passes<kColRadix, kFwd>(
      logA, ColPasses<kFwd>{ColGeo{logA, logC, xnp}, logB, logT, b0, smem, x + off, y + off,
                            f, Lazy64{f.q, 2 * f.q}, GlobalTw{f.tw, f.tws}, SharedTw{stw}});
}

// K8's items: `nrows` rows of 2^logB words, each a whole B-point network;
// stage l, group i reads entry i, offset by 2^l for X^B + 1 (xnp).  Word
// kk of an item lies at tile word p + kk * S, and at the same offset in
// device memory from the block's first word.
struct RowItem {
  int p, S, G;
};

struct RowGeo {
  int logB, nrows, xnp;
  __device__ __forceinline__ int items(int r) const { return nrows << (logB - r); }
  template <int kR>
  __device__ __forceinline__ RowItem item(int k, int l0) const {
    const int lw = logB - kR, logT = logB - l0 - kR;
    const int j = k >> lw, w = k & ((1 << lw) - 1);
    const int i0 = w >> logT, rr = w & ((1 << logT) - 1);
    return RowItem{(j << logB) + (i0 << (logB - l0)) + rr, 1 << logT, (xnp << l0) + i0};
  }
};

// One radix-2^kR pass of K8 over the block's items, thread-strided.
// kIn: the words come from x, reduced mod q; otherwise from the tile.
// kOut: the words go to y as canonical residues (the inverse's times
// n_inv); otherwise to the tile.  Adjacent words (S = 1) move 16 bytes
// at a time where x (wide_in) or y (wide_out) is 16-byte aligned.
template <int kR, bool kFwd, bool kIn, bool kOut, class Tw>
__device__ __forceinline__ void row_pass(const RowGeo& geo, int l0, uint64_t* s,
                                         const uint64_t* __restrict__ x,
                                         uint64_t* __restrict__ y, bool wide_in,
                                         bool wide_out, const Ring& f, const Lazy64& ar,
                                         const Tw& tw) {
  constexpr int kN = 1 << kR;
  const int items = geo.items(kR);
  for (int k = threadIdx.x; k < items; k += kThreads) {
    const RowItem it = geo.item<kR>(k, l0);
    uint64_t v[kN];
    if (kIn && it.S == 1 && kN >= 2 && wide_in) {
      const ulonglong2* x2 = reinterpret_cast<const ulonglong2*>(x + it.p);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const ulonglong2 u = x2[i];
        v[2 * i] = reduce_any(u.x, f.q, f.one_s);
        v[2 * i + 1] = reduce_any(u.y, f.q, f.one_s);
      }
    } else if (kIn) {
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) v[kk] = reduce_any(x[it.p + kk * it.S], f.q, f.one_s);
    } else {
      const uint64_t* b = s + radix::padded<kRowPad>(it.p);
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) v[kk] = b[radix::padded_step<kRowPad>(kk, it.S)];
    }
    radix::network<kR, kFwd>(v, it.G, ar, tw);
    if (kOut) {
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kFwd) {
          const uint64_t u = v[kk] >= ar.q2 ? v[kk] - ar.q2 : v[kk];
          v[kk] = u >= f.q ? u - f.q : u;
        } else {
          v[kk] = shoup_mul(v[kk], f.n_inv, f.n_inv_s, f.q);
        }
      }
      if (it.S == 1 && kN >= 2 && wide_out) {
        ulonglong2* y2 = reinterpret_cast<ulonglong2*>(y + it.p);
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          ulonglong2 u;
          u.x = v[2 * i];
          u.y = v[2 * i + 1];
          y2[i] = u;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) y[it.p + kk * it.S] = v[kk];
      }
    } else {
      uint64_t* b = s + radix::padded<kRowPad>(it.p);
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) b[radix::padded_step<kRowPad>(kk, it.S)] = v[kk];
    }
  }
}

// K8's log B stages over a block's rows (radix::passes): ceil(log B / 3)
// radix-8 passes.  The first pass reads x (reduced mod q) with the
// plan's tables, the last writes y, the others read and write the tile
// with the block's copy of the tables.
template <bool kFwd>
struct RowPasses {
  RowGeo geo;
  uint64_t* s;
  const uint64_t* __restrict__ x;
  uint64_t* __restrict__ y;
  bool wide_in, wide_out;
  Ring f;
  Lazy64 ar;
  GlobalTw gtw;
  SharedTw tw;
  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    if constexpr (kIn)
      row_pass<kR, kFwd, kIn, kOut>(geo, l0, s, x, y, wide_in, wide_out, f, ar, gtw);
    else
      row_pass<kR, kFwd, kIn, kOut>(geo, l0, s, x, y, wide_in, wide_out, f, ar, tw);
  }
};

// K8: whole B-point rows, 2^kLogRowTile / B of them per block; x -> y.
// Forward: CT stages.  Inverse: GS stages, then n_inv (B^-1).  The
// block's first row r0 names its ring (an RNS schedule's entry r0 >>
// shift: the rows of a block lie in one ring, row_shape_ok).  The table
// and its companion are copied to shared memory for the passes after
// the first.  kLogB: the row width the kernel is compiled for, or 0 for
// any (logB).  Rows of 512 words, which K8's callers give it, run an
// instance in which the compiler knows every stride.
template <bool kFwd, class F, int kLogB>
__global__ void __launch_bounds__(kThreads, row_blocks<kFwd>())
row_mat(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, long long nrows, int logB_,
        F fs, int xnp) {
  const int logB = kLogB ? kLogB : logB_;
  __shared__ uint64_t s[(1 << kLogRowTile) + ((1 << kLogRowTile) >> kRowPad)];
  __shared__ Twiddle stw[1 << kMaxRowLog];
  const int log_rows = kLogRowTile - logB;
  const long long r0 = (long long)blockIdx.x << log_rows;
  const Ring f = fs.at(r0);
  const int rows = nrows - r0 < (1LL << log_rows) ? (int)(nrows - r0) : 1 << log_rows;
  const size_t off = (size_t)r0 << logB;
  if (logB > kRowRadix)  // read after the first barrier
    for (int e = threadIdx.x; e < (1 << (logB - 1 + xnp)); e += kThreads)
      stw[e] = Twiddle{__ldg(f.tw + e), __ldg(f.tws + e)};
  radix::passes<kRowRadix, kFwd>(
      logB, RowPasses<kFwd>{RowGeo{logB, rows, xnp}, s, x + off, y + off,
                            aligned16(x + off), aligned16(y + off), f, Lazy64{f.q, 2 * f.q},
                            GlobalTw{f.tw, f.tws}, SharedTw{stw}});
}

// log2 of K7's column count: the tile holds 2^kLogColTile words, or the
// whole ring when B is narrower.
int col_log(int logA, int logB) {
  const int c = kLogColTile - logA;
  return c < logB ? c : logB;
}

// Shapes K7 covers: A = 2..512 columns of B >= 2 words, rings of at most
// 2^30 words (so that the twist's table offsets fit 32 bits), a
// power-of-two tile T <= B, and a grid within 2^31 blocks.
bool col_shape_ok(long long batch, int logA, int logB, int logT) {
  return batch > 0 && logA >= 1 && logA <= 9 && logB >= 1 && logA + logB <= 30 && logT >= 0 &&
         logT <= logB && batch < (1LL << 31) &&
         (batch << (logB - col_log(logA, logB))) < (1LL << 31);
}

// Shapes K8 covers: rows of B = 2..512 words, a grid within 2^31 blocks.
bool row_shape_ok(long long nrows, int logB) {
  return nrows > 0 && logB >= 1 && logB <= kMaxRowLog && nrows < (1LL << 40) &&
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

// K7's instance for A = 2^logA columns, C = 2^logC a block: the
// route's A = 128, 256 and 512 at the full tile run one compiled for
// their shape.
template <bool kFwd, class F>
auto col_kernel(int logA, int logC) {
  if (logA + logC == kLogColTile) {
    if (logA == 7) return col_mat<kFwd, F, 7>;
    if (logA == 8) return col_mat<kFwd, F, 8>;
    if (logA == 9) return col_mat<kFwd, F, 9>;
  }
  return col_mat<kFwd, F, 0>;
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
    const auto k = col_kernel<true, F>(logA, logC);
    if (int rc = fit_smem(k, bytes)) return rc;
    k<<<grid, kThreads, bytes, st>>>(x, y, logA, logB, logC, f, logT, xnp);
  } else {
    const auto k = col_kernel<false, F>(logA, logC);
    if (int rc = fit_smem(k, bytes)) return rc;
    k<<<grid, kThreads, bytes, st>>>(x, y, logA, logB, logC, f, logT, xnp);
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
  if (inverse) {
    const auto k = logB == kMaxRowLog ? row_mat<false, F, kMaxRowLog> : row_mat<false, F, 0>;
    k<<<grid, kThreads, 0, st>>>(x, y, nrows, logB, f, xnp);
  } else {
    const auto k = logB == kMaxRowLog ? row_mat<true, F, kMaxRowLog> : row_mat<true, F, 0>;
    k<<<grid, kThreads, 0, st>>>(x, y, nrows, logB, f, xnp);
  }
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
