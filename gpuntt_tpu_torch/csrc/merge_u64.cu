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
// One launch a transform up to logn 15 (the route's split log A 0,
// hopper_merge.split), two above.
//
// Whole rings, logn 11-15 (ring).  A ring of N = 2^15 u64 is 256 KiB, more
// than the 227 KB of shared memory a block can hold, but not more than a
// thread-block cluster holds: the ring lies on a cluster of
// C = 2^max(logn - 12, 0) blocks (one plain block at logn 11-12, clusters
// of 2, 4 and 8 at 13, 14 and 15), block c holding words [c T, (c + 1) T)
// of it, T = N / C <= 2^12 (32 KiB of shared memory and its padding).
// The ring's first r stages (r = 3 at logn 12 and 15, 2 at 11 and 14, 1
// at 13: every stage that pairs words of two blocks, and the logn mod 3
// stages a radix-8 network leaves over) are one pass whose items (2^r
// words N / 2^r apart) span the cluster: forward, it reads x from device
// memory and writes each word to the tile of the block that owns it,
// through distributed shared memory (mapa and st.shared::cluster); one
// cluster barrier later, stages r .. logn - 1 are full radix-8 passes
// local to each block, and the tile goes out canonical, the lanes of a
// warp on adjacent words.  The inverse mirrors it: the Barrett product
// (or the reduce) on the first load, 16 bytes a lane, the local passes
// from stage logn - 1 down, a cluster barrier, then stages r - 1 .. 0
// reading every tile of the cluster and storing y times n^-1.  A cluster
// barrier before a peer's tile is first written (forward) or after it is
// last read (inverse), and one between the two phases: two a launch.  So
// a transform reads and writes the batch once, where two launches did it
// twice; the cost is the words of the first pass that cross the cluster
// (7/8 of them at logn 15, 3/4 at 14, 1/2 at 13).
//   What bounds it is not the bytes but the instructions.  At the u64 HE
// product's call (240 rings of 2^15 under 15 moduli, an H100 at 700 W) a
// forward moves 126 MB (0.038 ms at 3.35 TB/s) and takes ~0.144 ms.  Its
// SASS issues ~300 instructions a word (~135 of them IMAD: 8.5 Shoup
// products a word), ~0.072 ms at one instruction a clock on every
// scheduler: the kernel runs at about half its issue bound, as the two
// launches did, so one pass over device memory in place of two saves
// ~6% (a forward 0.152 -> 0.144 ms, the product 0.486 -> 0.455 ms).
// With a part taken out (outputs wrong): every butterfly, -52%; every
// twiddle load, -6%; distributed shared memory, -10%.  The design holds
// the instructions down: each thread's items of a pass are written out
// (16 words a pass in flight, no loop), the cluster's peers are reached
// by 32-bit shared::cluster addresses, a pass reads its ring's constants
// where it uses them, and the forward's tile leaves through 8-byte
// stores on adjacent words.  A cluster of 4 blocks of 2^13 words (72
// KiB, 3 blocks an SM, 80 registers), which moves 3/4 of the words
// across the cluster, was no faster: the product took +1.9% and -0.9% in
// two turns, +52% with its four items a pass written out (PERF.md
// section 6).
//
// Rows and columns, logn 16-17.  A ring of N = 2^16 u64 is 512 KiB, so the
// ring is viewed as an (A, B) matrix, element j at (j / B, j % B), with
// B = 2^max(ceil(logn / 2), 7): (log A, log B) = (8, 8), (8, 9) at logn
// 16-17, the route's split there.  The entries also take this split at
// logn 11-15 ((4, 7), (5, 7), (6, 7), (7, 7), (7, 8)), the route's before
// whole rings, so that the two can be compared on the card.
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
// first, then columns, then n^-1.  Two launches a transform: the ring does
// not fit a cluster of 8 blocks at 4 an SM.
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
//     memory a block).  No row or column instance spills; six of the
//     thirty whole-ring ones (logn 11-14) spill 4-16 bytes, none at logn
//     15.
// Measured against the alternatives (their times are in CHANGES.md, in
// the entry of the K1-K3 redesign, and summed up in PERF.md section 6):
// 32 columns a tile took 0-4% longer; an interleaved (w, ws) copy of the
// row tables saved 0-3% of some launches for a second copy of every
// table, and staging a block's row twiddles in shared memory cost
// 10-20%; 3 blocks an SM (80 registers) took 2-6% longer.  The patch
// that restored them as -D options is in the repository's history.
// Tensor cores and TMA are not used: the work is 64-bit integer
// arithmetic, which tensor cores do not do; clusters only for whole
// rings, for their shared memory.  The whole-ring kernel's cluster size
// depends on the ring, so it is launched with cudaLaunchKernelEx and a
// cluster attribute rather than a compile-time __cluster_dims__.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "merge_u64_large.cuh"
#include "radix.cuh"

namespace merge_u64 {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRadix = 3;                               // radix-8 passes
constexpr int kLogColTile = 12;                         // 2^12 words (32 KiB)
constexpr int kLogRowTile = 12;                         // 2^12 words (32 KiB + padding)
constexpr int kLogRingTile = 12;                        // a whole-ring block's words
constexpr int kLogWhole = 15;                           // whole rings up to 2^15 words
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

// A whole ring of 2^kLogN words on a cluster of 2^kLogC blocks, block c
// holding words [c T, (c + 1) T) in its padded tile, T = 2^kLogT.  The
// cross pass runs the ring's stages 0 .. kR0 - 1, every stage that pairs
// words of two blocks and the logn mod 3 stages that a radix-8 network
// leaves over (all three where none is), so that every other pass is a
// full radix-8 pass local to a block.  Its items (2^kR0 words N / 2^kR0
// apart) have 2^kSub words in each block's tile.
template <int kLogN>
struct Whole {
  static constexpr int kLogC = kLogN > kLogRingTile ? kLogN - kLogRingTile : 0;
  static constexpr int kLogT = kLogN - kLogC;
  static constexpr int kR0 = kLogN % kRadix >= kLogC && kLogN % kRadix ? kLogN % kRadix : kRadix;
  static constexpr int kSub = kR0 - kLogC;
  static constexpr int kQ = kLogN - kR0;  // log2 of the cross items' stride
  static constexpr int kBytes = 8 * ((1 << kLogT) + ((1 << kLogT) >> kRowPad));
  // every pass gives each thread the same number of items (written out)
  static_assert(kSub >= 0 && (kLogN - kR0) % kRadix == 0, "");
  static_assert((1 << (kLogT - kRadix)) % kThreads == 0, "");
  static_assert(kBytes <= 48 * 1024, "");  // no opt-in to more dynamic shared memory
};

// A word of the tile of block `rank` of the cluster, through distributed
// shared memory.  On the card a 32-bit shared::cluster address (mapa), so
// that an item's eight addresses take eight registers, not sixteen; in a
// host emulation the mapped pointer.
struct PeerWord {
#ifdef __CUDA_ARCH__
  uint32_t a;
  __device__ __forceinline__ PeerWord(const cg::cluster_group&, const uint64_t* local, int rank) {
    asm("mapa.shared::cluster.u32 %0, %1, %2;"
        : "=r"(a)
        : "r"((uint32_t)__cvta_generic_to_shared(local)), "r"(rank));
  }
  __device__ __forceinline__ uint64_t get() const {
    uint64_t v;
    asm volatile("ld.shared::cluster.u64 %0, [%1];" : "=l"(v) : "r"(a));
    return v;
  }
  __device__ __forceinline__ void set(uint64_t v) const {
    asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(a), "l"(v));
  }
#else
  uint64_t* p;
  __device__ __forceinline__ PeerWord(const cg::cluster_group& cluster, uint64_t* local,
                                      int rank)
      : p(cluster.map_shared_rank(local, rank)) {}
  __device__ __forceinline__ uint64_t get() const { return *p; }
  __device__ __forceinline__ void set(uint64_t v) const { *p = v; }
#endif
};

// The passes of a block of a whole ring.  Block c of the cluster of ring
// r holds words [c T, (c + 1) T) of it; a (and b) and y are the kernel's
// operands, the ring's first word r N past them.  The cross pass's item k
// of block c is the ring's item c T / 2^kR0 + k: word kk at ring word
// kg + kk N / 2^kR0, in the tile of block kk >> kSub.  A local pass of
// stages kL0 .. kL0 + 2 (kL0 >= kR0) runs on the block's own tile, its
// items as those of a row pass over a row of T words at row c of a (C, T)
// view: words p + kk S of the tile, S = 2^(logn - kL0 - 3), heap index
// (c << (kL0 - log C)) + i0 at stage kL0, offset by 2^kL0 for X^N + 1.  A
// thread's items of a pass (16 words from logn 12 on) are written out, so
// that their loads are in flight together.  Only what every pass reads is
// held (the table, its companion and q); r, c and a pass's own constants
// (the reduce's or the product's, n^-1) are read again where they are used
// (blockIdx, fs.at), so that no register holds them through the passes.
template <int kLogN, bool kFwd, RowIn kFrom, class F>
struct RingPasses {
  using S = Whole<kLogN>;
  const uint64_t* a;
  const uint64_t* b;
  uint64_t* y;
  F fs;
  int xnp;
  bool wide;  // the inverse: the block's words of a (and b) start 16-byte aligned
  uint64_t* s;
  const uint64_t* tws_;
  const uint64_t* tw_;
  uint64_t q;

  __device__ __forceinline__ static size_t ring() { return blockIdx.x >> S::kLogC; }
  __device__ __forceinline__ static int c() { return blockIdx.x & ((1 << S::kLogC) - 1); }
  // The ring's first word, and the block's first, past the operands'.
  __device__ __forceinline__ static size_t off() { return ring() << kLogN; }
  __device__ __forceinline__ static size_t blk() { return off() + ((size_t)c() << S::kLogT); }
  __device__ __forceinline__ Lazy64 ar() const { return Lazy64{q, 2 * q}; }
  __device__ __forceinline__ GlobalTw tw() const { return GlobalTw{tw_, tws_}; }

  // The cross pass's word kk of the item at ring word kg, in its block's
  // tile: this block's own at logn <= 12 (one block a ring).
  __device__ __forceinline__ uint64_t* cross_word(int kk, int kg) const {
    return s + radix::padded<kRowPad>(((kk & ((1 << S::kSub) - 1)) << S::kQ) + kg);
  }
  __device__ __forceinline__ uint64_t cross_get(const cg::cluster_group& cluster, int kk,
                                                int kg) const {
    if constexpr (S::kLogC == 0) return *cross_word(kk, kg);
    return PeerWord(cluster, cross_word(kk, kg), kk >> S::kSub).get();
  }
  __device__ __forceinline__ void cross_set(const cg::cluster_group& cluster, int kk, int kg,
                                            uint64_t v) const {
    if constexpr (S::kLogC == 0)
      *cross_word(kk, kg) = v;
    else
      PeerWord(cluster, cross_word(kk, kg), kk >> S::kSub).set(v);
  }

  // Stages 0 .. kR0 - 1.  Forward: x (any u64, reduced below 2q) to the
  // tiles; inverse: the tiles to y, times n^-1.
  __device__ __forceinline__ void cross(const cg::cluster_group& cluster) const {
    constexpr int kR = S::kR0, kN = 1 << kR;
    const Ring f = fs.at(ring());
    const uint64_t* x = a + off();
    uint64_t* out = y + off();
#pragma unroll
    for (int j = 0; j < (1 << (S::kLogT - kR)) / kThreads; ++j) {
      const int kg = (c() << (S::kLogT - kR)) + threadIdx.x + j * kThreads;
      uint64_t v[kN];
#pragma unroll
      for (int kk = 0; kk < kN; ++kk)
        v[kk] = kFwd ? shoup_mul_lazy(__ldg(x + kg + (kk << S::kQ)), 1, f.one_s, q)
                     : cross_get(cluster, kk, kg);
      radix::network<kR, kFwd>(v, xnp, ar(), tw());
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) {
        if (kFwd)
          cross_set(cluster, kk, kg, v[kk]);
        else
          out[kg + (kk << S::kQ)] = shoup_mul(v[kk], f.n_inv, f.n_inv_s, q);
      }
    }
  }

  // A local pass.  kIn (the inverse's first): the block's words of a (and
  // b) in, 16 bytes a time where `wide` (the items' words are adjacent
  // there, S = 1), reduced below 2q (kReduce) or their Barrett product
  // (kProduct); the others read the tile.  Every local pass writes the tile.
  template <int kL0, bool kIn>
  __device__ __forceinline__ void local() const {
    constexpr int kR = kRadix, kN = 1 << kR, kLogS = kLogN - kL0 - kR, kS = 1 << kLogS;
    static_assert(kL0 >= S::kR0 && kLogS >= 0 && (!kIn || kLogS == 0), "");
    const int cw = c() << S::kLogT;  // the block's first word in the ring
#pragma unroll
    for (int j = 0; j < (1 << (S::kLogT - kR)) / kThreads; ++j) {
      const int k = threadIdx.x + j * kThreads;
      const int i0 = k >> kLogS, p = (i0 << (kLogS + kR)) + (k & (kS - 1));
      uint64_t v[kN];
      if constexpr (kIn) {
        const Ring f = fs.at(ring());
        const auto in = [&](uint64_t u, uint64_t w) {
          return kFrom == kProduct ? barrett_mul(u, w, q, f.bit, f.mu)
                                   : shoup_mul_lazy(u, 1, f.one_s, q);
        };
        const uint64_t* x = a + blk() + p;
        const uint64_t* z = b + blk() + p;
        if (wide) {
#pragma unroll
          for (int h = 0; h < kN / 2; ++h) {
            const ulonglong2 u = reinterpret_cast<const ulonglong2*>(x)[h];
            const ulonglong2 w2 = kFrom == kProduct ? reinterpret_cast<const ulonglong2*>(z)[h] : u;
            v[2 * h] = in(u.x, w2.x);
            v[2 * h + 1] = in(u.y, w2.y);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < kN; ++kk) v[kk] = in(x[kk], kFrom == kProduct ? z[kk] : 0);
        }
      } else {
        const uint64_t* t = s + radix::padded<kRowPad>(p);
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) v[kk] = t[radix::padded_step<kRowPad>(kk, kS)];
      }
      radix::network<kR, kFwd>(v, (xnp << kL0) + ((cw + p) >> (kLogN - kL0)), ar(), tw());
      uint64_t* t = s + radix::padded<kRowPad>(p);
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) t[radix::padded_step<kRowPad>(kk, kS)] = v[kk];
    }
  }

  // The forward's output: the tile's canonical words to the block's words
  // of y, the lanes of a warp on adjacent words (no bank conflict, every
  // store a run of 256 bytes).
  __device__ __forceinline__ void tile_out() const {
    uint64_t* out = y + blk();
#pragma unroll 4
    for (int j = 0; j < (1 << S::kLogT) / kThreads; ++j) {
      const int w = threadIdx.x + j * kThreads;
      out[w] = canon4(s[radix::padded<kRowPad>(w)], ar());
    }
  }
};

// The forward's local passes from stage kL0 on, then the tile out; a
// barrier between two.
template <int kLogN, int kL0, class P>
__device__ __forceinline__ void forward_local(const P& p) {
  p.template local<kL0, false>();
  __syncthreads();
  if constexpr (kL0 + kRadix < kLogN)
    forward_local<kLogN, kL0 + kRadix>(p);
  else
    p.tile_out();
}

// The inverse's local passes of stages kTop - 1 down to kR0, the first of
// them reading the input; a barrier between two.
template <int kTop, int kR0, bool kFirst, class P>
__device__ __forceinline__ void inverse_local(const P& p) {
  p.template local<kTop - kRadix, kFirst>();
  if constexpr (kTop - kRadix > kR0) {
    __syncthreads();
    inverse_local<kTop - kRadix, kR0, false>(p);
  }
}

// Whole rings, either direction (see the note at the top).  Block =
// (ring, c), a cluster of 2^kLogC blocks a ring.  Forward: a -> y, any
// u64 reduced on load, canonical on store; inverse: a (kReduce) or a o b
// (kProduct) -> y, times n^-1.  a may equal y: every word is read before
// the cluster barrier that precedes its write.
template <int kLogN, bool kFwd, RowIn kFrom, class F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ring(const uint64_t* a, const uint64_t* b, uint64_t* y, F fs, int xnp) {
  extern __shared__ uint64_t smem[];
  using P = RingPasses<kLogN, kFwd, kFrom, F>;
  const cg::cluster_group cluster = cg::this_cluster();
  const Ring f = fs.at(P::ring());
  const bool wide = aligned16(a + P::blk()) && (kFrom != kProduct || aligned16(b + P::blk()));
  const P p{a, b, y, fs, xnp, wide, smem, f.tws, f.tw, f.q};
  if (kFwd) {
    cluster.sync();  // every tile of the cluster is there to be written
    p.cross(cluster);
    cluster.sync();
    forward_local<kLogN, P::S::kR0>(p);
  } else {
    inverse_local<kLogN, P::S::kR0, true>(p);
    cluster.sync();
    p.cross(cluster);
    cluster.sync();  // the peers read this block's tile until here
  }
}

// Whether a transform of this split is one launch (ring).
bool whole(int logn, int logA) { return logA == 0 && logn <= kLogWhole; }

// Shapes the kernels cover: logn 11-17 at the split of rows and columns,
// logn 11-15 whole (log A 0), and grids within 2^31 blocks (at most 2^5 a
// ring).
bool shape_ok(long long batch, int logn, int logA) {
  return logn >= 11 && logn <= 17 && (logA == logn - log_b(logn) || whole(logn, logA)) &&
         batch > 0 && batch < (1LL << 26);
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

// The whole-ring launch of either direction: a (and b) -> y, a cluster of
// 2^kLogC blocks a ring.
template <int kLogN, bool kFwd, RowIn kFrom, class F>
int ring_launch(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, F f,
                int xnp, cudaStream_t st) {
  using S = Whole<kLogN>;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1u << S::kLogC;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch << S::kLogC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const auto k = ring<kLogN, kFwd, kFrom, F>;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, a, b, y, f, xnp);
  return e == cudaSuccess ? launch_status() : (int)e;
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

// logA 0 (logn <= 15): one whole-ring launch; otherwise columns, then rows.
template <class F>
int forward(const uint64_t* x, uint64_t* y, long long batch, int logn, int logA, F f, int xnp,
            cudaStream_t st) {
  return on_logn(logn, [&](auto n) {
    constexpr int kLogN = decltype(n)::value;
    if constexpr (kLogN <= kLogWhole)
      if (logA == 0) return ring_launch<kLogN, true, kReduce>(x, x, y, batch, f, xnp, st);
    if (int rc = col_launch<kLogN, true>(x, y, batch, f, xnp, st)) return rc;
    return row_launch<kLogN, true, kSame>(y, y, y, batch, f, xnp, st);
  });
}

// kMul: INTT(a o b); otherwise INTT(a) (b unused).  logA 0 (logn <= 15):
// one whole-ring launch; otherwise rows, then columns.
template <bool kMul, class F>
int inverse(const uint64_t* a, const uint64_t* b, uint64_t* y, long long batch, int logn,
            int logA, F f, int xnp, cudaStream_t st) {
  return on_logn(logn, [&](auto n) {
    constexpr int kLogN = decltype(n)::value;
    constexpr RowIn kFrom = kMul ? kProduct : kReduce;
    const uint64_t* bb = kMul ? b : a;
    if constexpr (kLogN <= kLogWhole)
      if (logA == 0) return ring_launch<kLogN, false, kFrom>(a, bb, y, batch, f, xnp, st);
    if (int rc = row_launch<kLogN, false, kFrom>(a, bb, y, batch, f, xnp, st)) return rc;
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
  return forward(x, y, batch, logn, logA, rns(mod_idx, shift, logn, tw, tws, consts, xnp), xnp,
                 (cudaStream_t)stream);
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

// K12's product in one call: rns_u64_forward on a (a -> fa) and on b
// (b -> fb), then rns_u64_polymul_inverse (fa, fb -> y), the same
// launches in that order (three at log A 0, six otherwise).  fa and fb
// are the caller's scratch spectra.
int rns_u64_polymul(int device, const uint64_t* a, const uint64_t* b, uint64_t* fa,
                    uint64_t* fb, uint64_t* y, long long batch, int logn, int logA,
                    const int* mod_idx, long long entries, int shift, const uint64_t* fwd_tw,
                    const uint64_t* fwd_tws, const uint64_t* inv_tw, const uint64_t* inv_tws,
                    const uint64_t* consts, int xnp, void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  const Stacked fwd = rns(mod_idx, shift, logn, fwd_tw, fwd_tws, consts, xnp);
  if (int rc = forward(a, fa, batch, logn, logA, fwd, xnp, st)) return rc;
  if (int rc = forward(b, fb, batch, logn, logA, fwd, xnp, st)) return rc;
  return inverse<true>(fa, fb, y, batch, logn, logA,
                       rns(mod_idx, shift, logn, inv_tw, inv_tws, consts, xnp), xnp, st);
}

}  // extern "C"
