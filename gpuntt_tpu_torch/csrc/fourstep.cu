// Hopper kernels of the 4-step NTT's column phase (sm_90a).
//
// They replace the column kernels of gpuntt_tpu/ops/pallas_mxu_4step.py:
//   fourstep_u64_col_fwd / fourstep_u64_col_inv  <- _col_kernel   (K9, :203)
//   fourstep_u32_col_fwd / fourstep_u32_col_inv  <- _col_kernel32 (K11, :483)
// and compute what those compute.  A ring of N = n1 * n2 words arrives in
// the 4-step's calling convention, pre-transposed as an (n2, n1) matrix
// (ops/fourstep.py).  The column phase runs the n1-point NTT along each
// of its n2 rows, transposes to (n1, n2), and multiplies by the twiddle
// matrix W:
//   forward: CT stages with the n1 table, then W[i, j] = root^(br(i) j);
//   inverse: GS stages with the inverse n1 table (no scaling), then
//            W^-1[i, j] = iroot^(i br(j)) -- the 4-step's own order, not
//            the big-ring inverse's (which twists before its columns).
// W is factored as an (n1, Tw) tile table times a per-tile scale
// (n2 / Tw, n1), so no N-entry table exists; the inverse factors too,
// with bit-reversed exponents (hopper_fourstep.py builds both).  The
// n2-point rows follow in other launches: whole rows of <= 512 words on
// merge_u64_large.cu's row kernel (K10) or merge_u32.cu (K11's row
// twin), longer rows on merge_u64.cu (K1/K2) or merge_u32.cu.  Outputs
// are canonical residues (the TPU's column kernels leave them lazy, below
// 2q or 3q), bit-identical to the plain versions; any input word is first
// reduced mod q (its low 32 bits for u32).
//
// Choice: butterflies, not digits.  The TPU kernels multiply each row by
// the n1 x n1 transform matrix as int8 digit matmuls on the MXU, because
// the TPU has no wide multiplier.  This card multiplies 64 x 64 -> 128
// and 32 x 32 -> 64 natively, so the matrix product is the radix-2 merge
// network of Shoup butterflies, as in merge_u64.cu.
//
// Tile: a block takes T adjacent rows of one ring's (n2, n1) matrix, T *
// n1 = 2^12 u64 or 2^13 u32 words (32 KiB; T = n2 when the ring is
// smaller).
//
// Bound: each launch reads and writes the ring once; at u64 2^24 x 1
// (n1 = 256) that is 256 MiB, 0.080 ms at 3.35 TB/s.  Its log n1 / 2 + 3
// Shoup products per word (u64: some 13 32-bit multiply-adds each, on
// the SM's 64-lane integer pipe) take about as long, and with the
// butterflies' adds, selects and addresses, longer.  So the n1-point
// transforms, which run along each input row's n1 contiguous words,
// take K8's register passes (merge_u64_large.cu), with as few
// instructions a word as they can:
//   - radix-8 passes (radix.cuh; n1 = 256: 2 + 3 + 3 forward, 3 + 3 + 2
//     inverse), lazy butterflies (Lazy64 for u64, q < 2^62; merge_u32's
//     Lazy for u32, q < 2^30), the n1 / 2-entry table in shared memory
//     for the passes after the first;
//   - the first pass reads x (reduced below 2q), an item along one row,
//     so that the lanes of a warp read adjacent words (16 bytes at a time
//     where an item's words are adjacent);
//   - the tile holds the rows transposed, (n1, T) with a bank swizzle
//     (ColPasses::at), and the passes after the first take the T rows of
//     one item together, the lanes of a warp on adjacent rows: one
//     twiddle, adjacent tile words, and in the last pass T adjacent words
//     of y (128 bytes at T = 16), which it writes directly, twisted
//     (the tile product lazy, the scale product canonical).  No
//     separate load, transpose or store pass remains.
//   - the 4-step's splits (n1 = 32-256) at the full tile run instances
//     compiled for their shape, 4 blocks an SM (64 registers; 3 and 80
//     with an RNS schedule); no spill.
// Tensor cores, TMA and clusters are not used: the work is 64- and
// 32-bit integer arithmetic.
//
// RNS (K14, ops/hopper_rns.py): the u64 kernel, a template over where a
// ring's constants come from (merge_u64.cuh), replaces
//   rns_fourstep_u64_col_fwd / _inv  <- _rns_4step_col_kernel
//                                       (gpuntt_tpu/ops/pallas_mxu_rns.py:629)
// a block's tile lies in one ring, so it reads that ring's modulus from
// the schedule once and the modulus's rows of the stacked column and W
// tables.  The n2-point rows follow on merge_u64_large.cu's rns_u64_large_rowmat
// (<= 512 words) or merge_u64.cu's rns_u64_* (K12).
//
// Lanes: u32 values ride in int64 lanes, as in merge_u32.cu; the tile
// keeps 32-bit words.  Index width: global offsets are size_t, and
// shape_ok keeps every grid within 2^31 blocks.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fourstep.cuh"
#include "radix.cuh"

namespace fourstep {
namespace {

using merge_u64::OneModulus;
using merge_u64::Ring;
using merge_u64::Stacked;

constexpr int kThreads = 256;
constexpr int kRadix = 3;     // log2 words of an item (radix-8 passes)
constexpr int kMaxLog1 = 9;   // n1 <= 512

// Blocks an SM holds, so that no instance spills: 4 (64 registers a
// thread) for the route's shapes (kLog1 > 0) on one modulus, 3 (80) where
// a block reads its modulus from an RNS schedule, 2 (128) for the generic
// instance, whose pass radix is known only at run time.
template <class F, int kLog1>
constexpr int col_blocks() {
  return kLog1 == 0 ? 2 : std::is_same<F, Stacked>::value ? 3 : 4;
}

// log2 words of the largest tile: 32 KiB of the word type.
template <class W>
__host__ __device__ constexpr int log_tile() {
  return sizeof(W) == 8 ? 12 : 13;
}

// An item of a pass of 2^kR words from stage l0: words kk at column
// i + kk S of the block's row j (of its T rows of the (n2, n1) matrix),
// whose group has table entry G.  The first pass, which reads x, takes
// items along a row (kByRow: the lanes of a warp read adjacent words of
// x); the others take the T rows of one column range (the lanes of a
// warp take adjacent rows j: the same twiddle, adjacent tile words and,
// in the last pass, adjacent words of y).
struct Item {
  int j, i, S, G;
};

template <int kR, bool kByRow>
__device__ __forceinline__ Item item(int k, int l0, int log1, int logT) {
  const int lw = log1 - kR;
  const int j = kByRow ? k >> lw : k & ((1 << logT) - 1);
  const int w = kByRow ? k & ((1 << lw) - 1) : k >> logT;
  const int logS = log1 - l0 - kR, i0 = w >> logS;
  return Item{j, (i0 << (log1 - l0)) + (w & ((1 << logS) - 1)), 1 << logS, i0};
}

// The passes of a block (radix::passes).  The tile holds the block's T
// rows transposed, word (i, j) at (i << logT) + (j ^ ((i ^ (i >> kRadix))
// & mask)): a row of the (n1, T) tile is a run of words whose order
// depends on i, so that the first pass's stores (lanes along i, one or
// 2^kRadix words apart) meet no bank conflict, and the other passes'
// accesses (lanes along j) none either.  The first pass reduces x below
// 2q; the last twists each word by W (W^-1) and writes it canonically
// to the (n1, n2) output, whose row i holds it at column j0 + j.
template <class W, bool kFwd>
struct ColPasses {
  int log1, log2, logT, logTw, j0, mask;
  W* s;
  const uint64_t* __restrict__ x;  // the block's first row
  uint64_t* __restrict__ y;        // column j0 of the ring's output
  Ring f;
  typename Word<W>::Ar ar;
  GlobalTw<W> gtw;
  SharedTw<W> tw;

  __device__ __forceinline__ int at(int i, int j) const {
    return (i << logT) + (j ^ ((i ^ (i >> kRadix)) & mask));
  }

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR;
    constexpr bool kByRow = kIn && !kOut;
    const W q = (W)f.q, one_s = (W)f.one_s;
    const int items = 1 << (log1 + logT - kR);
    // 16-byte loads where an item's words are adjacent and x allows them
    const bool wide = kByRow && kN >= 2 && ((uintptr_t)x & 15) == 0;
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const Item it = item<kR, kByRow>(k, l0, log1, logT);
      W v[kN];
      if (kIn) {
        const uint64_t* p = x + (it.j << log1) + it.i;
        if (wide && it.S == 1) {
#pragma unroll
          for (int h = 0; h < kN / 2; ++h) {
            const ulonglong2 u = __ldg(reinterpret_cast<const ulonglong2*>(p) + h);
            v[2 * h] = Word<W>::reduce(u.x, q, one_s);
            v[2 * h + 1] = Word<W>::reduce(u.y, q, one_s);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kN; ++kk) v[kk] = Word<W>::reduce(__ldg(p + kk * it.S), q, one_s);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) v[kk] = s[at(it.i + kk * it.S, it.j)];
      }
      if constexpr (kIn)
        radix::network<kR, kFwd>(v, it.G, ar, gtw);
      else
        radix::network<kR, kFwd>(v, it.G, ar, tw);
      if (kOut) {
        // table offsets below n1 n2 <= 2^30 (shape_ok): 32-bit
        const int b = j0 + it.j, tb = b & ((1 << logTw) - 1), sb = (b >> logTw) << log1;
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) {
          const int a = it.i + kk * it.S, t = (a << logTw) + tb, u = sb + a;
          y[((size_t)a << log2) + it.j] = Word<W>::twist(
              v[kk], __ldg(f.wt + t), __ldg(f.wts + t), __ldg(f.ws + u), __ldg(f.wss + u), q);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) s[at(it.i + kk * it.S, it.j)] = v[kk];
      }
    }
  }
};

// Block = (ring, tile of 2^logT rows of its (n2, n1) matrix); x -> y.
// The n1-point network of every row (forward CT, inverse GS), then the
// twist, in log n1 / 3 register passes.  The column table (n1 / 2
// entries, cyclic) is copied to shared memory for the passes after the
// first.  kLog1: the n1 the kernel is compiled for, with the full tile
// of 2^log_tile words, or 0 for any (log1, logT).
template <class W, bool kFwd, class F, int kLog1>
__global__ void __launch_bounds__(kThreads, col_blocks<F, kLog1>())
cols(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int log1_, int log2, int logT_,
     int logTw, F fs) {
  extern __shared__ uint64_t smem[];
  __shared__ typename Word<W>::Tw stw[1 << (kMaxLog1 - 1)];
  const int log1 = kLog1 ? kLog1 : log1_, logT = kLog1 ? log_tile<W>() - kLog1 : logT_;
  const int tiles_log = log2 - logT;
  const size_t ring = blockIdx.x >> tiles_log;
  const Ring f = fs.at(ring);
  const int j0 = (int)(blockIdx.x & ((1u << tiles_log) - 1)) << logT;
  const size_t base = ring << (log1 + log2);
  if (log1 > kRadix)  // read after the first barrier
    for (int e = threadIdx.x; e < (1 << (log1 - 1)); e += kThreads)
      stw[e] = Word<W>::twiddle(__ldg(f.tw + e), __ldg(f.tws + e));
  constexpr int kBank = 128 / sizeof(W);  // words of one pass over the banks
  const int mask = ((1 << logT) < kBank ? 1 << logT : kBank) - 1;
  radix::passes<kRadix, kFwd>(
      log1, ColPasses<W, kFwd>{log1, log2, logT, logTw, j0, mask, reinterpret_cast<W*>(smem),
                               x + base + ((size_t)j0 << log1), y + base + j0, f,
                               {(W)f.q, (W)(2 * f.q)}, GlobalTw<W>{f.tw, f.tws},
                               SharedTw<W>{stw}});
}

// The instance for n1 = 2^log1 and tiles of 2^logT rows: the 4-step's
// splits (n1 = 32-256, params/fourstep.py) at the full tile run one
// compiled for their shape.
template <class W, bool kFwd, class F>
auto col_kernel(int log1, int logT) {
  if (log1 + logT == log_tile<W>()) {
    if (log1 == 5) return cols<W, kFwd, F, 5>;
    if (log1 == 6) return cols<W, kFwd, F, 6>;
    if (log1 == 7) return cols<W, kFwd, F, 7>;
    if (log1 == 8) return cols<W, kFwd, F, 8>;
  }
  return cols<W, kFwd, F, 0>;
}

// Shapes the kernels cover: n1 = 2..512 columns, rows of n2 >= 2 words,
// rings of at most 2^30 words (so that the twist's table offsets fit 32
// bits), a tile of T <= n2 rows within 32 KiB, a W tile Tw <= n2, and a
// grid within 2^31 blocks.
template <class W>
bool shape_ok(long long batch, int log1, int log2, int logT, int logTw) {
  return batch > 0 && log1 >= 1 && log1 <= 9 && log2 >= 1 && log1 + log2 <= 30 && logT >= 0 &&
         logT <= log2 && log1 + logT <= log_tile<W>() && logTw >= 0 && logTw <= log2 &&
         batch < (1LL << 31) && (batch << (log2 - logT)) < (1LL << 31);
}

int launch_status() {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e;
}

template <class W, bool kFwd, class F>
int launch_cols(int device, const uint64_t* x, uint64_t* y, long long batch, int log1,
                int log2, int logT, int logTw, F f, void* stream) {
  if (!shape_ok<W>(batch, log1, log2, logT, logTw)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  // at most 32 KiB: under the 48 KB static limit
  const int bytes = (int)sizeof(W) << (log1 + logT);
  const auto k = col_kernel<W, kFwd, F>(log1, logT);
  k<<<(int)(batch << (log2 - logT)), kThreads, bytes, st>>>(x, y, log1, log2, logT, logTw, f);
  return launch_status();
}

// One modulus: its column table and W tables, q and one_s.
OneModulus one(const uint64_t* tw, const uint64_t* tws, const uint64_t* wt,
               const uint64_t* wts, const uint64_t* ws, const uint64_t* wss, uint64_t q,
               uint64_t one_s) {
  return OneModulus{Ring{tw, tws, wt, wts, ws, wss, q, one_s, 0, 0, 0, 0}};
}

// An RNS schedule (ring i uses modulus mod_idx[i]) over the stacked
// tables: the n1 / 2-entry column table, the (n1, Tw) tile and
// (n2 / Tw, n1) scale tables, each with its Shoup companion.
Stacked rns(const int* mod_idx, int log1, int log2, int logTw, const uint64_t* tw,
            const uint64_t* tws, const uint64_t* wt, const uint64_t* wts, const uint64_t* ws,
            const uint64_t* wss, const uint64_t* consts) {
  return Stacked{mod_idx, 0, Ring{tw, tws, wt, wts, ws, wss, 0, 0, 0, 0, 0, 0},
                 1LL << (log1 - 1), 1LL << (log1 + logTw), 1LL << (log1 + log2 - logTw),
                 consts};
}

}  // namespace
}  // namespace fourstep

using namespace fourstep;

// Every entry: pointers to contiguous (batch, 2^log1 * 2^log2) int64 lanes
// on card `device` (x and y must not overlap): x in the 4-step's (n2, n1)
// layout, y in (n1, n2); the column table (n1 / 2 entries, bit-reversed,
// X^n1 - 1 indexing) with its Shoup companion, and the W tile (2^log1,
// 2^logTw) and scale (2^(log2 - logTw), 2^log1) tables with theirs, all as
// int64 words; logT the block's tile of rows.  Each launches on `stream`,
// allocates nothing, does not synchronise, and returns the cudaError_t of
// its launch (0 = none).  The rns_* entries take the same shapes with an
// int32 schedule (ring i uses modulus mod_idx[i], every entry in [0,
// mod_count)), those tables stacked on a leading (mod_count,) axis, and
// the (mod_count, 6) constants of the stacked column plan.
extern "C" {

int fourstep_u64_col_fwd(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int log1, int log2, int logT, int logTw, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, uint64_t q, uint64_t one_s,
                         void* stream) {
  return launch_cols<uint64_t, true>(device, x, y, batch, log1, log2, logT, logTw,
                                     one(tw, tws, wt, wts, ws, wss, q, one_s), stream);
}

int fourstep_u64_col_inv(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int log1, int log2, int logT, int logTw, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, uint64_t q, uint64_t one_s,
                         void* stream) {
  return launch_cols<uint64_t, false>(device, x, y, batch, log1, log2, logT, logTw,
                                      one(tw, tws, wt, wts, ws, wss, q, one_s), stream);
}

int fourstep_u32_col_fwd(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int log1, int log2, int logT, int logTw, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, uint32_t q, uint32_t one_s,
                         void* stream) {
  return launch_cols<uint32_t, true>(device, x, y, batch, log1, log2, logT, logTw,
                                     one(tw, tws, wt, wts, ws, wss, q, one_s), stream);
}

int fourstep_u32_col_inv(int device, const uint64_t* x, uint64_t* y, long long batch,
                         int log1, int log2, int logT, int logTw, const uint64_t* tw,
                         const uint64_t* tws, const uint64_t* wt, const uint64_t* wts,
                         const uint64_t* ws, const uint64_t* wss, uint32_t q, uint32_t one_s,
                         void* stream) {
  return launch_cols<uint32_t, false>(device, x, y, batch, log1, log2, logT, logTw,
                                      one(tw, tws, wt, wts, ws, wss, q, one_s), stream);
}

int rns_fourstep_u64_col_fwd(int device, const uint64_t* x, uint64_t* y, long long batch,
                             int log1, int log2, int logT, int logTw, const int* mod_idx,
                             const uint64_t* tw, const uint64_t* tws, const uint64_t* wt,
                             const uint64_t* wts, const uint64_t* ws, const uint64_t* wss,
                             const uint64_t* consts, void* stream) {
  return launch_cols<uint64_t, true>(
      device, x, y, batch, log1, log2, logT, logTw,
      rns(mod_idx, log1, log2, logTw, tw, tws, wt, wts, ws, wss, consts), stream);
}

int rns_fourstep_u64_col_inv(int device, const uint64_t* x, uint64_t* y, long long batch,
                             int log1, int log2, int logT, int logTw, const int* mod_idx,
                             const uint64_t* tw, const uint64_t* tws, const uint64_t* wt,
                             const uint64_t* wts, const uint64_t* ws, const uint64_t* wss,
                             const uint64_t* consts, void* stream) {
  return launch_cols<uint64_t, false>(
      device, x, y, batch, log1, log2, logT, logTw,
      rns(mod_idx, log1, log2, logTw, tw, tws, wt, wts, ws, wss, consts), stream);
}

}  // extern "C"
