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
// reads its modulus once.
//
// Choice: butterflies, not digits.  The TPU kernels cut each product
// into int8 digit matmuls because the TPU has no wide multiplier.  This
// card multiplies 64 x 64 -> 128 natively (__umul64hi), so the transform
// is the reference's merge network of Shoup butterflies.
//
// Two launches through device memory.  A ring of N = 2^16 u64 is 512 KiB,
// more than the 227 KB of shared memory a block can hold, so the ring is
// viewed as an (A, B) matrix, element j at (j / B, j % B), with the
// route's split B = 2^max(ceil(logn / 2), 7) (hopper_merge.split):
// (log A, log B) = (4, 7), (5, 7), (6, 7), (7, 7), (7, 8), (8, 8), (8, 9)
// at logn 11-17.
//   - Columns: the first log A stages pair elements B * t apart, an
//     A-point network down each column; stage l, group i reads table
//     entry i, offset by 2^l for X^N + 1.  A block takes C adjacent
//     columns of one ring, a tile of A * C = 2^12 words (32 KiB of shared
//     memory; C = 16 at A = 256, the whole ring below logn 13).
//   - Rows: the last log B stages pair elements within a row; row a,
//     local stage l, group i reads entry (a << l) + i of the same table,
//     offset by 2^(log A + l) for X^N + 1, so the TPU factorization's W
//     matrix is folded into the row stages and costs no pass of its own.
//     A block takes 2^12 words of whole rows of one ring (the whole ring
//     at logn 11).
// The inverse runs the Gentleman-Sande network the other way: rows
// first, then columns, then n^-1.  Two launches a transform: one launch
// over a cluster's distributed shared memory would halve the bytes, and
// is not tried here.
//
// Bound: each launch reads and writes the batch once (at 2^16 x 128, 64
// MiB each way: 0.040 ms at 3.35 TB/s).  Its log A or log B / 2 Shoup
// products a word are some 13 32-bit multiply-adds each on the SM's
// 64-lane integer pipe: with the butterflies' adds, selects and
// addresses, the instructions take longer than the bytes.  So the
// kernels spend as few instructions a word as they can, as K7 and K8 do
// (merge_u64_large.cu):
//   - Register passes (radix.cuh): each phase's 4-9 stages run as at most
//     three radix-8 passes (the short one first forward and last
//     inverse), an item 8 words of one column (columns) or one row (rows)
//     in a thread's registers, 2 barriers where the radix-2 stages took
//     one a stage.  Each (log A, log B) pair is an instance of its own, so
//     every stride, item count and pass split is a constant.
//   - No load or store pass of its own: the first pass reads the input,
//     the last writes the output.  The forward columns reduce any u64
//     word below 2q on the way in; K3's inverse rows form the Barrett
//     product a o b there, K2's and K12's reduce below 2q; the inverse
//     columns multiply by n^-1 on the way out; every stored word is
//     canonical.
//   - Lazy (Harvey) butterflies (merge_u64_large.cuh, Lazy64): values stay
//     below 4q inside a launch.  4q < 2^64 needs q < 2^62, which the
//     wrappers (hopper_merge.takes, hopper_rns.takes) require.
//   - Columns: the lanes of a warp take adjacent columns of the same rows
//     (each access to x, y or the tile a run of adjacent words, no
//     padding; the warp's twiddle one broadcast); the A-entry column table
//     and its companion are copied to shared memory once a block for the
//     passes after the first.
//   - Rows: each row has its own B - 1 twiddles, about one 16-byte pair a
//     word transformed; the passes read them from the plan's two tables
//     in device memory (L2 holds them: 1 MiB at 2^16), the items of a row
//     sharing the first passes' entries.  The tile has one spare word
//     after every 8 (as K8's); where an item's 8 words are adjacent (the
//     forward's last pass, the inverse's first) they move 16 bytes at a
//     time, when the block's operand is 16-byte aligned (checked once a
//     block; 8-byte accesses otherwise).
//   - Occupancy: every instance is compiled for 4 blocks an SM (64
//     registers a thread, 32 warps; the tiles take 34-36 KiB of shared
//     memory a block), and none spills.
// Measured against the alternatives (their times are in CHANGES.md, in
// the entry of the K1-K3 redesign, and summed up in PERF.md section 6):
// 32 columns a tile took 0-4% longer; an interleaved (w, ws) copy of the
// row tables saved 0-3% of some launches for a second copy of every
// table, and staging a block's row twiddles in shared memory cost
// 10-20%; 3 blocks an SM (80 registers) took 2-6% longer.  The patch
// that restored them as -D options is in the repository's history.
// Tensor cores, TMA and clusters are not used: the work is 64-bit
// integer arithmetic, which tensor cores do not do.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "merge_u64_large.cuh"
#include "radix.cuh"

namespace merge_u64 {
namespace {

constexpr int kThreads = 256;
constexpr int kRadix = 3;                               // radix-8 passes
constexpr int kLogColTile = 12;                         // 2^12 words (32 KiB)
constexpr int kLogRowTile = 12;                         // 2^12 words (32 KiB + padding)
constexpr int kRowPad = 3;                              // one spare tile word after every 8
constexpr int kMinBlocks = 4;                           // blocks an SM: 64 registers, no spill

constexpr int min_c(int a, int b) { return a < b ? a : b; }

// The route's split (hopper_merge.split): B = 2^max(ceil(logn / 2), 7).
constexpr int log_b(int logn) { return (logn + 1) / 2 > 7 ? (logn + 1) / 2 : 7; }

// The split of a 2^kLogN ring and its tiles: C = 2^kLogC columns a column
// block, R = 2^kLogR rows a row block.
template <int kLogN>
struct Shape {
  static constexpr int kLogB = log_b(kLogN);
  static constexpr int kLogA = kLogN - kLogB;
  static constexpr int kLogC = min_c(kLogColTile - kLogA, kLogB);
  static constexpr int kLogR = min_c(kLogRowTile, kLogN) - kLogB;
};

// [0, 4q) -> [0, q).
__device__ __forceinline__ uint64_t canon4(uint64_t v, const Lazy64& ar) {
  const uint64_t u = v >= ar.q2 ? v - ar.q2 : v;
  return u >= ar.q ? u - ar.q : u;
}

// The column passes of a block (radix::passes): the C columns of an
// (A, C) tile, each the A-point network down its column.  Item k of a
// pass of 2^kR words from stage l0 holds rows row + kk S of column c = k
// mod C; the lanes of a warp take adjacent columns of the same rows.
// The first pass reads x (forward: any u64, reduced below 2q; inverse:
// the rows' canonical output), the last writes y (forward: canonical;
// inverse: times n^-1).  x and y point at the block's first column of
// its ring, whose rows lie B words apart; the inverse runs in place
// (x == y), each block reading all its words before it writes any.
template <int kLogN, bool kFwd>
struct ColPasses {
  using S = Shape<kLogN>;
  int xnp;
  uint64_t* s;
  const uint64_t* x;
  uint64_t* y;
  Ring f;
  Lazy64 ar;
  GlobalTw gtw;
  SharedTw tw;

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR, kC = 1 << S::kLogC;
    const int logS = S::kLogA - l0 - kR;
    for (int k = threadIdx.x; k < (1 << (S::kLogA - kR + S::kLogC)); k += kThreads) {
      const int c = k & (kC - 1), w = k >> S::kLogC, i0 = w >> logS;
      const int row = (i0 << (S::kLogA - l0)) + (w & ((1 << logS) - 1));
      const int g = (row << S::kLogB) + c, gs = 1 << (logS + S::kLogB);
      uint64_t* t = s + (row << S::kLogC) + c;
      const int ts = 1 << (logS + S::kLogC);
      uint64_t v[kN];
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (!kIn)
          v[kk] = t[kk * ts];
        else if (kFwd)
          v[kk] = shoup_mul_lazy(__ldg(x + g + kk * gs), 1, f.one_s, f.q);
        else
          v[kk] = x[g + kk * gs];
      }
      const int G = (xnp << l0) + i0;
      if constexpr (kIn)
        radix::network<kR, kFwd>(v, G, ar, gtw);
      else
        radix::network<kR, kFwd>(v, G, ar, tw);
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (!kOut)
          t[kk * ts] = v[kk];
        else if (kFwd)
          y[g + kk * gs] = canon4(v[kk], ar);
        else
          y[g + kk * gs] = shoup_mul(v[kk], f.n_inv, f.n_inv_s, f.q);
      }
    }
  }
};

// Columns, either direction.  Block = (ring, C columns); x -> y.  The
// column table and its companion are copied to shared memory for the
// passes after the first (log A >= 4: always two passes or three).
template <int kLogN, bool kFwd, class F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cols(const uint64_t* x, uint64_t* y, F fs, int xnp) {
  using S = Shape<kLogN>;
  __shared__ uint64_t s[1 << (S::kLogA + S::kLogC)];
  __shared__ Twiddle stw[1 << S::kLogA];
  constexpr int kTilesLog = S::kLogB - S::kLogC;
  const size_t ring = blockIdx.x >> kTilesLog;
  const Ring f = fs.at(ring);
  const size_t off = (ring << kLogN) + ((blockIdx.x & ((1 << kTilesLog) - 1)) << S::kLogC);
  const GlobalTw gtw{f.tw, f.tws};
  for (int e = threadIdx.x; e < (1 << (S::kLogA - 1 + xnp)); e += kThreads) stw[e] = gtw(e);
  radix::passes<kRadix, kFwd>(
      S::kLogA, ColPasses<kLogN, kFwd>{xnp, s, x + off, y + off, f, Lazy64{f.q, 2 * f.q},
                                       gtw, SharedTw{stw}});
}

// What the first row pass reads: the forward's own canonical words
// (kSame), any u64 word reduced below 2q (kReduce, K2), or the Barrett
// product a o b (kProduct, K3).
enum RowIn { kSame, kReduce, kProduct };

// The row passes of a block (radix::passes): R whole rows of B words,
// rows a0 .. a0 + R - 1 of their ring.  Item k of a pass of 2^kR words
// from stage l0 holds words p + kk S of the tile (row j = p >> log B);
// its group's heap index is (a0 + j) << l0 plus its group, offset by
// 2^(log A + l0) for X^N + 1.  The first pass reads a (and b), the last
// writes y canonically; 16 bytes at a time where an item's words are
// adjacent (S = 1) and the operand allows it.  a, b and y point at the
// block's first word; the forward runs in place (a == y).
template <int kLogN, bool kFwd, RowIn kFrom>
struct RowPasses {
  using S = Shape<kLogN>;
  int xnp, a0;
  bool wide_in, wide_out;
  uint64_t* s;
  const uint64_t* a;
  const uint64_t* b;
  uint64_t* y;
  Ring f;
  Lazy64 ar;
  GlobalTw tw;

  __device__ __forceinline__ uint64_t in(uint64_t u, uint64_t w) const {
    if (kFrom == kReduce) return shoup_mul_lazy(u, 1, f.one_s, f.q);
    if (kFrom == kProduct) return barrett_mul(u, w, f.q, f.bit, f.mu);
    return u;
  }

  __device__ __forceinline__ uint64_t out(uint64_t v) const {
    if (kFwd) return canon4(v, ar);
    return v >= f.q ? v - f.q : v;  // GS values lie below 2q
  }

  template <int kR, bool kIn, bool kOut>
  __device__ __forceinline__ void run(int l0) const {
    constexpr int kN = 1 << kR, kLw = S::kLogB - kR;
    const int logT = S::kLogB - l0 - kR;
    for (int k = threadIdx.x; k < (1 << (S::kLogR + kLw)); k += kThreads) {
      const int j = k >> kLw, w = k & ((1 << kLw) - 1);
      const int i0 = w >> logT, rr = w & ((1 << logT) - 1), St = 1 << logT;
      const int p = (j << S::kLogB) + (i0 << (S::kLogB - l0)) + rr;
      uint64_t v[kN];
      if (kIn && logT == 0 && wide_in) {
#pragma unroll
        for (int h = 0; h < kN / 2; ++h) {
          const ulonglong2 u = reinterpret_cast<const ulonglong2*>(a + p)[h];
          const ulonglong2 w2 =
              kFrom == kProduct ? reinterpret_cast<const ulonglong2*>(b + p)[h] : u;
          v[2 * h] = in(u.x, w2.x);
          v[2 * h + 1] = in(u.y, w2.y);
        }
      } else if (kIn) {
#pragma unroll
        for (int kk = 0; kk < kN; ++kk)
          v[kk] = in(a[p + kk * St], kFrom == kProduct ? b[p + kk * St] : 0);
      } else {
        const uint64_t* t = s + radix::padded<kRowPad>(p);
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) v[kk] = t[radix::padded_step<kRowPad>(kk, St)];
      }
      const int G = (xnp << (S::kLogA + l0)) + ((a0 + j) << l0) + i0;
      radix::network<kR, kFwd>(v, G, ar, tw);
      if (kOut && logT == 0 && wide_out) {
#pragma unroll
        for (int h = 0; h < kN / 2; ++h) {
          ulonglong2 u;
          u.x = out(v[2 * h]);
          u.y = out(v[2 * h + 1]);
          reinterpret_cast<ulonglong2*>(y + p)[h] = u;
        }
      } else if (kOut) {
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) y[p + kk * St] = out(v[kk]);
      } else {
        uint64_t* t = s + radix::padded<kRowPad>(p);
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) t[radix::padded_step<kRowPad>(kk, St)] = v[kk];
      }
    }
  }
};

// Rows, either direction.  Block = (ring, R rows); a (and b) -> y.
template <int kLogN, bool kFwd, RowIn kFrom, class F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows(const uint64_t* a, const uint64_t* b, uint64_t* y, F fs, int xnp) {
  using S = Shape<kLogN>;
  constexpr int kWords = 1 << (S::kLogR + S::kLogB);
  __shared__ uint64_t s[kWords + (kWords >> kRowPad)];
  constexpr int kPerRingLog = S::kLogA - S::kLogR;
  const size_t ring = blockIdx.x >> kPerRingLog;
  const int a0 = (blockIdx.x & ((1 << kPerRingLog) - 1)) << S::kLogR;
  const Ring f = fs.at(ring);
  const size_t off = (ring << kLogN) + ((size_t)a0 << S::kLogB);
  const bool wide_in = aligned16(a + off) && (kFrom != kProduct || aligned16(b + off));
  const bool wide_out = aligned16(y + off);
  radix::passes<kRadix, kFwd>(
      S::kLogB, RowPasses<kLogN, kFwd, kFrom>{xnp, a0, wide_in, wide_out, s, a + off, b + off,
                                              y + off, f, Lazy64{f.q, 2 * f.q},
                                              GlobalTw{f.tw, f.tws}});
}

// Shapes the kernels cover: the route's split at logn 11-17, and grids
// within 2^31 blocks (the row grid is the larger, at most 2^5 a ring).
bool shape_ok(long long batch, int logn, int logA) {
  return logn >= 11 && logn <= 17 && logA == logn - log_b(logn) && batch > 0 &&
         batch < (1LL << 26);
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

// The column launch of either direction: x -> y.
template <int kLogN, bool kFwd, class F>
int col_launch(const uint64_t* x, uint64_t* y, long long batch, F f, int xnp,
               cudaStream_t st) {
  using S = Shape<kLogN>;
  cols<kLogN, kFwd><<<(int)(batch << (S::kLogB - S::kLogC)), kThreads, 0, st>>>(x, y, f, xnp);
  return launch_status();
}

// The row launch of either direction: a (and b) -> y.
template <int kLogN, bool kFwd, RowIn kFrom, class F>
int row_launch(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, F f,
               int xnp, cudaStream_t st) {
  using S = Shape<kLogN>;
  const auto k = rows<kLogN, kFwd, kFrom, F>;
  k<<<(int)(batch << (kLogN - S::kLogR - S::kLogB)), kThreads, 0, st>>>(a, b, y, f, xnp);
  return launch_status();
}

// fn(std::integral_constant<int, logn>) for the instance of `logn`.
template <class Fn>
int on_logn(int logn, Fn fn) {
  switch (logn) {
    case 11: return fn(std::integral_constant<int, 11>{});
    case 12: return fn(std::integral_constant<int, 12>{});
    case 13: return fn(std::integral_constant<int, 13>{});
    case 14: return fn(std::integral_constant<int, 14>{});
    case 15: return fn(std::integral_constant<int, 15>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 17: return fn(std::integral_constant<int, 17>{});
  }
  return (int)cudaErrorInvalidValue;
}

template <class F>
int forward(const uint64_t* x, uint64_t* y, long long batch, int logn, F f, int xnp,
            cudaStream_t st) {
  return on_logn(logn, [&](auto n) {
    constexpr int kLogN = decltype(n)::value;
    if (int rc = col_launch<kLogN, true>(x, y, batch, f, xnp, st)) return rc;
    return row_launch<kLogN, true, kSame>(y, y, y, batch, f, xnp, st);
  });
}

// kMul: INTT(a o b); otherwise INTT(a) (b unused).
template <bool kMul, class F>
int inverse(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, int logn,
            F f, int xnp, cudaStream_t st) {
  return on_logn(logn, [&](auto n) {
    constexpr int kLogN = decltype(n)::value;
    const uint64_t* bb = kMul ? b : a;
    if (int rc = row_launch<kLogN, false, kMul ? kProduct : kReduce>(a, bb, y, batch, f, xnp,
                                                                     st))
      return rc;
    return col_launch<kLogN, false>(y, y, batch, f, xnp, st);
  });
}

// The stacked tables of an RNS schedule: 2^logn entries per modulus for
// X^N + 1, 2^(logn-1) for X^N - 1.
Stacked rns(const int* mod_idx, int shift, int logn, const uint64_t* tw, const uint64_t* tws,
            const uint64_t* consts, int xnp) {
  const long long len = xnp ? 1LL << logn : 1LL << (logn - 1);
  return stacked(mod_idx, shift, tw, tws, len, consts);
}

}  // namespace
}  // namespace merge_u64

using namespace merge_u64;

// Every entry: pointers to contiguous (batch, 2^logn) u64 rows on card
// `device`, logA the route's split (hopper_merge.split), launches on
// `stream`, allocates nothing, does not synchronise, and returns the
// cudaError_t of its launches (0 = none).  The merge_u64_* entries take
// one modulus: its table with its Shoup companion and its numbers.  The
// rns_u64_* entries (K12) take an int32 schedule of batch >> shift moduli
// (ring i uses modulus mod_idx[i >> shift], every entry in [0,
// mod_count)), the stacked (mod_count, table) tables and the
// (mod_count, 6) constants of ops/rns.py's RNSMergePlan.  q < 2^62.
extern "C" {

int merge_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                      int logA, const uint64_t* tw, const uint64_t* tws, uint64_t q,
                      uint64_t one_s, int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, one_modulus(tw, tws, q, one_s), xnp,
                 (cudaStream_t)stream);
}

int merge_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                      int logA, const uint64_t* tw, const uint64_t* tws, uint64_t q,
                      uint64_t one_s, uint64_t n_inv, uint64_t n_inv_s, int xnp,
                      void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn,
                        one_modulus(tw, tws, q, one_s, n_inv, n_inv_s), xnp,
                        (cudaStream_t)stream);
}

int merge_u64_polymul_inverse(int device, const uint64_t* fa, const uint64_t* fb,
                              uint64_t* y, long long batch, int logn, int logA,
                              const uint64_t* tw, const uint64_t* tws, uint64_t q, int bit,
                              uint64_t mu, uint64_t n_inv, uint64_t n_inv_s, int xnp,
                              void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<true>(fa, fb, y, batch, logn,
                       one_modulus(tw, tws, q, 0, n_inv, n_inv_s, bit, mu), xnp,
                       (cudaStream_t)stream);
}

int rns_u64_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                 (cudaStream_t)stream);
}

int rns_u64_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* tws, const uint64_t* consts, int xnp,
                    void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false>(x, nullptr, y, batch, logn,
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
  return inverse<true>(fa, fb, y, batch, logn,
                       rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                       (cudaStream_t)stream);
}

// K12's product in one call: rns_u64_forward on a (a -> fa) and on b
// (b -> fb), then rns_u64_polymul_inverse (fa, fb -> y), the same six
// launches in that order.  fa and fb are the caller's scratch spectra.
int rns_u64_polymul(int device, const uint64_t* a, const uint64_t* b, uint64_t* fa,
                    uint64_t* fb, uint64_t* y, long long batch, int logn, int logA,
                    const int* mod_idx, long long entries, int shift, const uint64_t* fwd_tw,
                    const uint64_t* fwd_tws, const uint64_t* inv_tw, const uint64_t* inv_tws,
                    const uint64_t* consts, int xnp, void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const Stacked fwd = rns(mod_idx, shift, logn, fwd_tw, fwd_tws, consts, xnp);
  if (int rc = forward(a, fa, batch, logn, fwd, xnp, st)) return rc;
  if (int rc = forward(b, fb, batch, logn, fwd, xnp, st)) return rc;
  return inverse<true>(fa, fb, y, batch, logn,
                       rns(mod_idx, shift, logn, inv_tw, inv_tws, consts, xnp), xnp, st);
}

}  // extern "C"
