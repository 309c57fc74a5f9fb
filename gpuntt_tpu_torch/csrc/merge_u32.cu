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
//   rns_u32_polymul         <- _rns32_fwd_kernel twice, then the fused
//                              inverse, in one launch at logn 14-15
//                              (cluster_product; no TPU kernel fuses them)
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
// 32-bit Shoup constant product.
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
// Split rule (one rule for logn 7-25; hopper_merge32.split mirrors it):
//   A = 1 up to logn 15: one launch over whole rings, one pass over device
//   memory a transform, with the reduce (and the n^-1 scaling) in that
//   launch.  Above, B = 2^13 up to logn 22, B = 2^15 for logn 23-25;
//   A = N / B; the tile holds W = max(B, 2^13) u32 words: 32 KiB up to
//   logn 22, 128 KiB above, as dynamic shared memory (cudaFuncSetAttribute
//   past 48 KB).
//   logn <= 13: 2^13 / N rings a block (rows).
//   logn 14-15: one ring a cluster of two blocks (cluster_ring), each
//   block's tile half the ring (32 or 64 KiB), two blocks an SM.  A block
//   holding a whole 128 KiB ring would leave its SM one block, whose
//   loads, passes and stores would not overlap another's: a forward at
//   2^15 x 480 on 4-byte words took 0.188 ms so (0.158 with 512 threads),
//   0.132 on the clusters; at 2^14 x 960, one ring a block (64 KiB, two
//   blocks an SM) and the clusters time alike (0.111, 0.112 ms), the
//   fused inverse 5% faster on the clusters.
//   logn 16-22: A = 8..512, C = 2^13 / A = 1024..16 columns.
//   logn 23-25: A = 256..1024, C = 128..32 columns.
//
// The clusters at logn 14-15 (cluster_ring).  Block c of a ring's
// cluster holds words [c N/2, (c + 1) N/2): row c of the ring's (2, N/2)
// view.  The ring's stages 0-4 are one pass whose items (32 words N/32
// apart) span both halves: forward, it reads x from device memory into
// registers and writes each item's first 16 words to the first half's
// tile and its last 16 to the second's, one of them the peer block's,
// through distributed shared memory (cluster.map_shared_rank); one
// cluster barrier later, stages 5-9 and 10 .. logn - 1 are passes local
// to each half, and each block stores its half 16 bytes a lane.  The
// inverse mirrors it: its half into the tile (with the fused product),
// stages logn - 1 .. 10 and 9-5 locally, a cluster barrier, then stages
// 4-0 reading both tiles and storing y, scaled by n^-1.  Two blocks an SM
// (128 registers a thread), each a half of another ring, so one ring's
// loads overlap another's passes.  The bound: a forward at 2^15 x 480 on
// 4-byte words must read and write 126 MB (0.038 ms at 3.35 TB/s); it
// takes 0.131 ms, of which the twiddle table's reads (8 bytes an entry,
// the modulus's whole table a ring, each lane its own subtree in the last
// pass) are about 30%, distributed shared memory 5%.
//
// The fused product at logn 14-15 (cluster_product).  INTT(NTT(a) o
// NTT(b)) of a row pair in one launch, on a cluster of 2^(logn - 13)
// blocks (four at 2^15), block c holding 2^13 words of each ring (row c
// of each ring's (kC, N/kC) view, 66 KiB padded, two blocks an SM): both
// spectra stay on chip, so a call reads a and b once and writes the
// product once, 189 MB at 2^15 x 480 on 4-byte words (0.056 ms at 3.35
// TB/s), where the three launches move 441 MB.  The forwards run as
// cluster_ring's, one loop body taking a's items, then b's (pass2):
// stages 0-4 from device memory into the cluster's tiles, a cluster
// barrier, stages 5-9, then the last pass, which leaves canonical
// residues in the tile.  Each thread then takes the items whose words it
// has just stored, reads the Barrett product of a's and b's, and runs the
// inverse's stages logn - 1 .. 10, with no barrier; then stages 9-5, a
// cluster barrier, and stages 4-0 into y with n^-1, as cluster_ring's
// inverse.  A thread runs a's item and b's item of one twiddle subtree
// back to back, so b's twiddle reads hit L1.  Alternatives measured at
// 2^15 x 480 on int32 lanes (H100, 700 W), against 0.367 ms for this one
// and 0.436 for the three launches: a cluster of two blocks, each holding
// half of both rings (132 KiB, one block an SM), 0.565; both rings' words
// as pairs in registers (one twiddle read for both) through the
// forwards' last stages, the product and the inverse's first, with the
// forwards' passes unrolled per ring, 0.665: 64 words an item left no
// registers to prefetch twiddles, and twice the code (12,552
// instructions, ~200 KB) slowed every pass.  Clusters of four leave 8 of
// the 132 SMs without a block (124 used).
//
// What bounds a launch, and the design.  A transform at 2^20 x 16 must
// read and write its batch once, 256 MiB of int64 lanes (0.080 ms at
// 3.35 TB/s); its 13 * 2^27 butterflies of three 32-bit multiplies each
// are far below the integer rate, so the function is bound by device
// memory.  A launch that runs one stage per pass over shared memory is
// not: a barrier and a tile pass per stage, and the index arithmetic
// and two twiddle words per butterfly, hold a 13-stage row launch near
// 1 TB/s.  So each launch runs its stages as radix-32 passes in
// registers (csrc/radix.cuh): a thread takes an item of 2^5 words (2^r
// in the short pass), runs 5 stages on them and hands them on through
// the tile.  An L-stage network is ceil(L / 5) passes with a barrier
// between two (network()):
//   - Rows of 2^13: passes of 5, 5 and 3 stages; rows of 2^15: three of
//     5.  The forward's first pass reads its words from device memory,
//     32 a thread in flight at a stride of B / 32 (the lanes of a warp
//     on adjacent words); the inverse copies its rows into the tile 16
//     bytes a lane first (tile_in), and both copy the tile out 16 bytes a
//     lane (tile_out): 3 barriers forward, 4 inverse.  Rows are at least
//     64 words (logn >= 7): two passes.
//   - Columns: A <= 32 is one pass from device memory to device memory,
//     A = 64..1024 two with one barrier.  An item holds one column's
//     words, and the lanes of a warp hold adjacent columns, so every
//     read and write of device memory is coalesced.
//   - The tile has one spare word after every 32 (radix::padded): the
//     lanes of a pass of 32 words read and write 32 distinct banks at
//     every stride, and an item's offsets depend on its stride alone.
//   - Twiddles: an item reads the 2^r - 1 entries of one subtree of the
//     table's heap, from a heap index computed once per item.  The row
//     launch reads them through __ldg from the plan's packed table, one
//     8-byte word per entry holding the entry and its Shoup companion;
//     the column launch's entries, the same for every column, are copied
//     to shared memory once per block for its passes after the first.
//   - Lazy butterflies (merge_u32.cuh, Lazy): values stay in [0, 4q)
//     inside a launch and become canonical residues as they are stored.
//     q < 2^30, so 4q < 2^32 and no step wraps.  The values between the
//     column and the row launch are canonical, as the plain versions
//     (and the engine) hold them where they split the network.
//   - 128 registers a thread, 2 blocks an SM (__launch_bounds__): an
//     item of 32 words and its 31 twiddles fit without spilling.
// Tensor cores and TMA are not used: the work is integer arithmetic on
// 32-bit words; clusters only at logn 14-15, for their shared memory.
//
// Lanes: every kernel keeps its tile in 32-bit words and is a template
// over the word it reads and writes in device memory (Wide):
//   - uint64_t, the port's int64 lanes holding values < 2^32 (the
//     merge_u32_* entries and the rns_u32_* ones): 8-byte words, twice the
//     bytes of the values;
//   - uint32_t, int32 lanes (the rns_u32_*_i32 entries, for u32 RNS
//     ladders held as 4-byte words): half the bytes a pass.
// Rows move 16 bytes a lane (2 or 4 words) where the block's words start
// 16-byte aligned, and one word a lane where a caller's view starts
// elsewhere (aligned16, checked once a block); columns move one word a
// lane, the lanes of a warp on adjacent words.
//
// An RNS batch adds its ring's modulus's table to each block's reads:
// 512 KiB of packed table per modulus at 2^16 for X^N + 1, 4 MiB for a
// ladder of 8, which L2 (50 MB) holds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "merge_u32.cuh"
#include "radix.cuh"

namespace merge_u32 {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kLogTile = 13;       // log2 words of the smallest tile (32 KiB)
constexpr int kLogTileLarge = 15;  // log2 words of the largest tile (128 KiB)
constexpr int kRadix = 5;          // log2 words of an item of a pass inside the tile
constexpr int kPad = 5;            // one spare tile word after every 2^kPad
constexpr int kBlocks = 2;         // blocks an SM holds (128 registers a thread)
constexpr int kCluster = 2;        // blocks a ring takes from 2^kLogCluster words on
constexpr int kLogCluster = 14;    // log2 words of the least ring a cluster holds
constexpr int kLogPart = 13;       // log2 words of each ring a block of the fused product holds

// Words of a padded tile that holds 2^logw words.
__host__ __device__ inline int padded_words(int logw) {
  return (1 << logw) + ((1 << logw) >> kPad);
}

// A work item of a pass: word kk lies at tile word p + kk * S and at
// device word g + kk * gs past the block's base; G is the heap index of
// its group at the pass's first stage (radix.cuh).
struct Item {
  int p, S, G;
  size_t g, gs;
};

// The items of a row pass: `nrows` rows of 2^logB words, the first of
// them global row r0 (ring r0 >> logA, row r0 % A); row a's local stage
// l, group i reads entry ((a << l) + i), offset by 2^(logA + l) for X^N + 1.
struct RowGeo {
  int logA, logB, r0, nrows, xnp;
  __device__ __forceinline__ int words() const { return nrows << logB; }
  __device__ __forceinline__ int items(int r) const { return nrows << (logB - r); }
  template <int kR>
  __device__ __forceinline__ Item item(int k, int l0) const {
    const int lw = logB - kR, logT = logB - l0 - kR;
    const int j = k >> lw, w = k & ((1 << lw) - 1);
    const int i0 = w >> logT, rr = w & ((1 << logT) - 1);
    const int p = (j << logB) + (i0 << (logB - l0)) + rr;
    const int a = (r0 + j) & ((1 << logA) - 1);
    return Item{p, 1 << logT, (xnp << (logA + l0)) + (a << l0) + i0, (size_t)p,
                (size_t)1 << logT};
  }
};

// The items of a column pass over an (A, 2^logC) tile of a ring whose
// rows are 2^logB words: column c of the tile lies in one item's words,
// and the lanes of a warp take adjacent columns.
struct ColGeo {
  int logA, logB, logC, xnp;
  __device__ __forceinline__ int items(int r) const { return 1 << (logA + logC - r); }
  template <int kR>
  __device__ __forceinline__ Item item(int k, int l0) const {
    const int logT = logA - l0 - kR;
    const int c = k & ((1 << logC) - 1), w = k >> logC;
    const int i0 = w >> logT, rr = w & ((1 << logT) - 1);
    const int a = (i0 << (logA - l0)) + rr;
    return Item{(a << logC) + c, 1 << (logT + logC), (xnp << l0) + i0,
                ((size_t)a << logB) + c, (size_t)1 << (logT + logB)};
  }
};

// The items of a pass over a whole ring held by a cluster of kC blocks:
// those of a ring's row pass (logA 0), block c taking the c-th share of
// them.
template <int kC>
struct Cross {
  RowGeo ring;
  int c;
  __device__ __forceinline__ int items(int r) const { return ring.items(r) / kC; }
  template <int kR>
  __device__ __forceinline__ Item item(int k, int l0) const {
    return ring.template item<kR>(k + c * items(kR), l0);
  }
};
using CrossGeo = Cross<kCluster>;

// The tile in shared memory, padded (radix::padded).
struct Tile {
  uint32_t* s;
  template <int kN>
  __device__ __forceinline__ void get(const Item& it, uint32_t (&v)[kN]) const {
    const uint32_t* b = s + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) v[kk] = b[radix::padded_step<kPad>(kk, it.S)];
  }
  template <int kN>
  __device__ __forceinline__ void put(const Item& it, const uint32_t (&v)[kN]) const {
    uint32_t* b = s + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) b[radix::padded_step<kPad>(kk, it.S)] = v[kk];
  }
};

// A ring's two halves in the padded tiles of its cluster's blocks, lo
// holding words [0, N/2) and hi the rest (one of them the block's own
// tile, the other its peer's): an item of the ring's stages 0 .. r - 1
// (words N / 2^r apart) has its first 2^(r-1) words in lo and its last
// in hi, at the same offsets.
struct Halves {
  uint32_t* lo;
  uint32_t* hi;
  template <int kN>
  __device__ __forceinline__ void get(const Item& it, uint32_t (&v)[kN]) const {
    const uint32_t* a = lo + radix::padded<kPad>(it.p);
    const uint32_t* b = hi + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      v[kk] = a[radix::padded_step<kPad>(kk, it.S)];
      v[kk + kN / 2] = b[radix::padded_step<kPad>(kk, it.S)];
    }
  }
  template <int kN>
  __device__ __forceinline__ void put(const Item& it, const uint32_t (&v)[kN]) const {
    uint32_t* a = lo + radix::padded<kPad>(it.p);
    uint32_t* b = hi + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN / 2; ++kk) {
      a[radix::padded_step<kPad>(kk, it.S)] = v[kk];
      b[radix::padded_step<kPad>(kk, it.S)] = v[kk + kN / 2];
    }
  }
};

// The halves of the ring of block c of `cluster`, the block's tile smem.
__device__ __forceinline__ Halves halves(const cg::cluster_group& cluster, uint32_t* smem,
                                         int c) {
  uint32_t* peer = cluster.map_shared_rank(smem, c ^ 1);
  return c ? Halves{peer, smem} : Halves{smem, peer};
}

// A ring in the padded tiles of a cluster of kC blocks (the fused
// product's): part r, its words [r N/kC, (r + 1) N/kC), in block r's tile
// t[r].  An item of the ring's stages 0 .. 4 (32 words N/32 apart) has
// 32/kC words in each part, at the same offsets.
template <int kC>
struct Parts {
  uint32_t* t[kC];
  template <int kN>
  __device__ __forceinline__ void get(const Item& it, uint32_t (&v)[kN]) const {
    constexpr int m = kN / kC;
#pragma unroll
    for (int r = 0; r < kC; ++r) {
      const uint32_t* s = t[r] + radix::padded<kPad>(it.p);
#pragma unroll
      for (int kk = 0; kk < m; ++kk) v[r * m + kk] = s[radix::padded_step<kPad>(kk, it.S)];
    }
  }
  template <int kN>
  __device__ __forceinline__ void put(const Item& it, const uint32_t (&v)[kN]) const {
    constexpr int m = kN / kC;
#pragma unroll
    for (int r = 0; r < kC; ++r) {
      uint32_t* s = t[r] + radix::padded<kPad>(it.p);
#pragma unroll
      for (int kk = 0; kk < m; ++kk) s[radix::padded_step<kPad>(kk, it.S)] = v[r * m + kk];
    }
  }
};

// The parts of a ring in cluster `cluster`'s tiles, `at` words into each
// (block c's own tile smem).
template <int kC>
__device__ __forceinline__ Parts<kC> parts(const cg::cluster_group& cluster, uint32_t* smem,
                                           int c, int at) {
  Parts<kC> p;
#pragma unroll
  for (int r = 0; r < kC; ++r) p.t[r] = (r == c ? smem : cluster.map_shared_rank(smem, r)) + at;
  return p;
}

// The fused product's tile words: its forwards' last pass stores
// canonical residues (the forward's store) into the tile (Canon); its
// inverse's first pass reads the Barrett product of a's words and b's,
// `b` words further, reduced (the fused inverse's load) (Product).
struct Canon {
  uint32_t* s;
  Lazy ar;
  template <int kN>
  __device__ __forceinline__ void put(const Item& it, const uint32_t (&v)[kN]) const {
    uint32_t* p = s + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) p[radix::padded_step<kPad>(kk, it.S)] = ar.canon(v[kk]);
  }
};
struct Product {
  const uint32_t* s;
  int b;
  Ring f;
  template <int kN>
  __device__ __forceinline__ void get(const Item& it, uint32_t (&v)[kN]) const {
    const uint32_t* p = s + radix::padded<kPad>(it.p);
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) {
      const int o = radix::padded_step<kPad>(kk, it.S);
      v[kk] = reduce_any(barrett_mul(p[o], p[o + b], f.q, f.bit, f.mu), f.q, f.one_s);
    }
  }
};

// Whether a 16-byte access at p is aligned.
__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// 16 bytes of device memory as words of type W, at a 16-byte aligned
// address: two 8-byte words (ulonglong2) or four 4-byte ones (uint4).
template <class W>
struct Wide;
template <>
struct Wide<uint64_t> {
  static constexpr int kWords = 2;
  __device__ __forceinline__ static void load(const uint64_t* p, uint64_t (&v)[2]) {
    const ulonglong2 u = *reinterpret_cast<const ulonglong2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  }
  __device__ __forceinline__ static void store(uint64_t* p, const uint64_t (&v)[2]) {
    ulonglong2 u;
    u.x = v[0];
    u.y = v[1];
    *reinterpret_cast<ulonglong2*>(p) = u;
  }
};
template <>
struct Wide<uint32_t> {
  static constexpr int kWords = 4;
  __device__ __forceinline__ static void load(const uint32_t* p, uint32_t (&v)[4]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ __forceinline__ static void store(uint32_t* p, const uint32_t (&v)[4]) {
    uint4 u;
    u.x = v[0];
    u.y = v[1];
    u.z = v[2];
    u.w = v[3];
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// The launch's input, read by its first pass: the low 32 bits of each
// word of x (kMul: the Barrett product with b's), reduced mod q when
// `reduce`.  x may equal the output: every word is read before a
// barrier that precedes its write, or by the thread that writes it.
template <bool kMul_, class W>
struct In {
  static constexpr bool kMul = kMul_;
  using Word = W;
  const W* x;
  const W* b;
  Ring f;
  int reduce;
  __device__ __forceinline__ uint32_t word(W xv, W bv) const {
    const uint32_t v = kMul ? barrett_mul((uint32_t)xv, (uint32_t)bv, f.q, f.bit, f.mu)
                            : (uint32_t)xv;
    return reduce ? reduce_any(v, f.q, f.one_s) : v;
  }
  template <int kN>
  __device__ __forceinline__ void get(const Item& it, uint32_t (&v)[kN]) const {
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) {
      const size_t e = it.g + kk * it.gs;
      v[kk] = word(x[e], kMul ? b[e] : 0);
    }
  }
};

// The launch's output, written by its last pass: canonical residues
// (the forward's values lie in [0, 4q), the inverse's in [0, 2q)), or
// for the inverse's last phase (`scale`) the canonical product by n^-1.
template <bool kFwd, class W>
struct Out {
  using Word = W;
  W* y;
  Ring f;
  int scale;
  __device__ __forceinline__ uint32_t word(uint32_t v) const {
    if (kFwd) return cond_sub(cond_sub(v, 2 * f.q), f.q);
    return scale ? shoup_mul(v, f.n_inv, f.n_inv_s, f.q) : cond_sub(v, f.q);
  }
  template <int kN>
  __device__ __forceinline__ void put(const Item& it, const uint32_t (&v)[kN]) const {
#pragma unroll
    for (int kk = 0; kk < kN; ++kk) y[it.g + kk * it.gs] = word(v[kk]);
  }
};

// Twiddles: the packed table in device memory (read-only path), or the
// column launch's copy in shared memory.
struct GlobalTw {
  const uint64_t* t;
  __device__ __forceinline__ uint64_t operator()(int i) const {
    return __ldg(t + i);
  }
};
struct SharedTw {
  const uint64_t* t;
  __device__ __forceinline__ uint64_t operator()(int i) const { return t[i]; }
};

// One pass of radix 2^kR: every item of the block, thread-strided.
template <int kR, bool kFwd, class Geo, class Src, class Dst, class Tw>
__device__ __forceinline__ void pass(const Geo& geo, int l0, const Src& src, const Dst& dst,
                                     const Tw& tw, const Lazy& ar) {
  const int items = geo.items(kR);
  for (int k = threadIdx.x; k < items; k += kThreads) {
    const Item it = geo.template item<kR>(k, l0);
    uint32_t v[1 << kR];
    src.get(it, v);
    radix::network<kR, kFwd>(v, it.G, ar, tw);
    dst.put(it, v);
  }
}

// A pass whose radix is known only at run time (a network's short pass).
template <bool kFwd, class Geo, class Src, class Dst, class Tw>
__device__ __forceinline__ void pass_r(int r, const Geo& geo, int l0, const Src& src,
                                       const Dst& dst, const Tw& tw, const Lazy& ar) {
  switch (r) {
    case 1: pass<1, kFwd>(geo, l0, src, dst, tw, ar); break;
    case 2: pass<2, kFwd>(geo, l0, src, dst, tw, ar); break;
    case 3: pass<3, kFwd>(geo, l0, src, dst, tw, ar); break;
    case 4: pass<4, kFwd>(geo, l0, src, dst, tw, ar); break;
    default: pass<5, kFwd>(geo, l0, src, dst, tw, ar); break;
  }
}

// A pass over the items of two rings, a's then b's, one loop body for
// both (the fused product's forwards): src(r) and dst(r) are ring r's
// source and destination.  Where a ring's items are a multiple of
// kThreads, each thread takes the same items of both rings, one after
// the other, and the second reads its twiddles where the first left them
// (L1).
template <int kR, bool kFwd, class Geo, class Src, class Dst, class Tw>
__device__ __forceinline__ void pass2(const Geo& geo, int l0, const Src& src, const Dst& dst,
                                      const Tw& tw, const Lazy& ar) {
  const int items = geo.items(kR);
  for (int j = threadIdx.x; j < 2 * items; j += kThreads) {
    const int r = j >= items;
    const Item it = geo.template item<kR>(r ? j - items : j, l0);
    uint32_t v[1 << kR];
    src(r).get(it, v);
    radix::network<kR, kFwd>(v, it.G, ar, tw);
    dst(r).put(it, v);
  }
}

// Rows of the tile: `in` into the tile, or the tile to `out`, 16 bytes a
// lane where the block's words start 16-byte aligned and one word a lane
// where they do not (adjacent lanes on adjacent words either way, each
// 32-word run of the tile read or written without a bank conflict).
template <class Src, class Geo>
__device__ __forceinline__ void tile_in(const Src& in, const Geo& geo, uint32_t* tile) {
  using W = typename Src::Word;
  constexpr int kV = Wide<W>::kWords;
  if (aligned16(in.x) && (!Src::kMul || aligned16(in.b))) {
#pragma unroll 4
    for (int i = threadIdx.x; i < geo.words() / kV; i += kThreads) {
      W u[kV], w[kV];
      Wide<W>::load(in.x + kV * i, u);
      if (Src::kMul) Wide<W>::load(in.b + kV * i, w);
#pragma unroll
      for (int j = 0; j < kV; ++j)
        tile[radix::padded<kPad>(kV * i + j)] = in.word(u[j], Src::kMul ? w[j] : u[j]);
    }
  } else {
    for (int i = threadIdx.x; i < geo.words(); i += kThreads)
      tile[radix::padded<kPad>(i)] = in.word(in.x[i], Src::kMul ? in.b[i] : 0);
  }
}

template <class Dst, class Geo>
__device__ __forceinline__ void tile_out(const Dst& out, const Geo& geo, const uint32_t* tile) {
  using W = typename Dst::Word;
  constexpr int kV = Wide<W>::kWords;
  if (aligned16(out.y)) {
#pragma unroll 4
    for (int i = threadIdx.x; i < geo.words() / kV; i += kThreads) {
      W u[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) u[j] = out.word(tile[radix::padded<kPad>(kV * i + j)]);
      Wide<W>::store(out.y + kV * i, u);
    }
  } else {
    for (int i = threadIdx.x; i < geo.words(); i += kThreads)
      out.y[i] = out.word(tile[radix::padded<kPad>(i)]);
  }
}

// An L-stage network (CT stages 0 .. L-1 forward, GS stages L-1 .. 0
// inverse) over the block's items in ceil(L / kRadix) passes, a barrier
// between two: full passes of kRadix stages and a short one of
// L mod kRadix.  The first pass reads `src` (twiddles tw1), the last
// writes `dst`, the others read and write the tile (twiddles tw2).  The
// forward runs from stage 0 up and the inverse from stage L - 1 down;
// the short pass runs last, so that a first pass reading device memory
// holds 32 words a thread in flight, or first (`short_first`, the
// inverse rows, whose input is in the tile already: the forward's
// passes backwards).
template <bool kFwd, class Geo, class Src, class Dst, class Tw2>
__device__ __forceinline__ void network(int L, bool short_first, const Geo& geo,
                                        uint32_t* tile, const Src& src, const Dst& dst,
                                        const GlobalTw& tw1, const Tw2& tw2, const Lazy& ar) {
  // L <= kLogTileLarge, so np <= 3: the passes are written out, with no
  // loop counter to hold
  const int np = (L + kRadix - 1) / kRadix, short_r = L - (np - 1) * kRadix;
  const auto first = [&](int n) {  // the first stage of pass n
    const int r = (short_first ? n == 0 : n == np - 1) ? short_r : kRadix;
    const int done = short_first && n > 0 ? short_r + (n - 1) * kRadix : n * kRadix;
    return kFwd ? done : L - done - r;
  };
  const int r0 = short_first || np == 1 ? short_r : kRadix;
  const Tile t{tile};
  if (np == 1) {
    pass_r<kFwd>(r0, geo, first(0), src, dst, tw1, ar);
    return;
  }
  pass_r<kFwd>(r0, geo, first(0), src, t, tw1, ar);
  if (np == 3) {
    __syncthreads();
    pass<kRadix, kFwd>(geo, first(1), t, t, tw2, ar);
  }
  __syncthreads();
  pass_r<kFwd>(short_first ? kRadix : short_r, geo, first(np - 1), t, dst, tw2, ar);
}

// Column phase.  Block = (ring, 2^logC adjacent columns), an (A, 2^logC)
// tile.  Forward (first phase): reduce on load, CT stages.  Inverse (last
// phase): GS stages, n^-1 on store.  x may equal y.  The first pass reads
// x and the last writes y, the lanes of a warp on adjacent columns.
// Past one pass, the column table's entries (2^logA words at most)
// follow the tile in shared memory.
template <bool kFwd, class W, class F>
__global__ void __launch_bounds__(kThreads, kBlocks)
cols(const W* x, W* y, int logn, int logA, int logC, F fs, int xnp) {
  extern __shared__ uint32_t smem[];
  const int logB = logn - logA, tiles_log = logB - logC;
  const size_t ring = blockIdx.x >> tiles_log;
  const Ring f = fs.at(ring);
  const size_t off = (ring << logn) + ((size_t)(blockIdx.x & ((1u << tiles_log) - 1)) << logC);
  uint64_t* stw = reinterpret_cast<uint64_t*>(smem + padded_words(logA + logC));
  if (logA > kRadix)  // read after the first barrier
    for (int e = threadIdx.x; e < (1 << (logA - 1 + xnp)); e += kThreads) stw[e] = __ldg(f.tw + e);
  network<kFwd>(logA, false, ColGeo{logA, logB, logC, xnp}, smem,
                In<false, W>{x + off, nullptr, f, kFwd}, Out<kFwd, W>{y + off, f, !kFwd},
                GlobalTw{f.tw}, SharedTw{stw}, Lazy{f.q, 2 * f.q});
}

// Row phase.  Block = 2^log_rows consecutive rows of the (batch * A, B)
// view, the last block possibly short, all under one modulus (the
// launcher caps log_rows by F::ring_log).  `reduce`: reduce on load (the
// first phase); `scale`: n^-1 on store (the inverse's last phase).  kMul:
// the load is the Barrett product x o b, then reduced (the polymul's
// inverse).  x may equal y.  Rows (B >= 64: two passes at least) go out
// of the tile 16 bytes a lane where aligned (tile_out) after a barrier,
// and the inverse's come in the same way (tile_in); the forward's first pass
// reads x itself, 32 words a thread at a stride of B / 32, the lanes of
// a warp on adjacent words.  The output's constants are read after the
// passes, so that a stacked modulus's n^-1 holds no register through
// them.
template <bool kFwd, bool kMul, class W, class F>
__global__ void __launch_bounds__(kThreads, kBlocks)
rows(const W* x, const W* b, W* y, int total_rows, int logA, int logB, int log_rows, F fs,
     int reduce, int scale, int xnp) {
  extern __shared__ uint32_t smem[];
  const int r0 = (int)(blockIdx.x << log_rows);
  const int left = total_rows - r0;
  const int nrows = left < (1 << log_rows) ? left : (1 << log_rows);
  const size_t off = (size_t)r0 << logB, ring = (size_t)r0 >> logA;
  const Ring f = fs.at(ring);
  const RowGeo geo{logA, logB, r0, nrows, xnp};
  const GlobalTw tw{f.tw};
  const Lazy ar{f.q, 2 * f.q};
  const In<kMul, W> in{x + off, kMul ? b + off : nullptr, f, reduce};
  const Tile t{smem};
  if (kFwd) {
    network<kFwd>(logB, false, geo, smem, in, t, tw, tw, ar);
  } else {
    tile_in(in, geo, smem);
    __syncthreads();
    network<kFwd>(logB, true, geo, smem, t, t, tw, tw, ar);
  }
  __syncthreads();
  tile_out(Out<kFwd, W>{y + off, fs.at(ring), scale}, geo, smem);
}

// Whole rings from 2^kLogCluster words on (logA = 0; see the note at the
// top): block c of a ring's cluster holds half c in its tile, row c of
// the ring's (2, N/2) view, whose local stage l is the ring's l + 1.
// Forward: reduce on load, canonical residues on store.  Inverse: kMul's
// product and the reduce on load, n^-1 on store.  x may equal y: every
// word is read before the cluster barrier that precedes its write.
template <bool kFwd, bool kMul, class W, class F>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kBlocks)
cluster_ring(const W* x, const W* b, W* y, int logn, F fs, int xnp) {
  extern __shared__ uint32_t smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), logH = logn - 1;
  const size_t ring = blockIdx.x / kCluster, off = ring << logn;
  const Ring f = fs.at(ring);
  const CrossGeo cross{RowGeo{0, logn, 0, 1, xnp}, c};
  const RowGeo local{1, logH, c, 1, xnp};
  const GlobalTw tw{f.tw};
  const Lazy ar{f.q, 2 * f.q};
  const Tile t{smem};
  const int last = logn - 2 * kRadix;  // stages in the pass of 10 .. logn - 1
  if (kFwd) {
    cluster.sync();  // the peer's tile is there to be written
    pass<kRadix, true>(cross, 0, In<false, W>{x + off, nullptr, f, 1},
                       halves(cluster, smem, c), tw, ar);
    cluster.sync();
    pass<kRadix, true>(local, kRadix - 1, t, t, tw, ar);
    __syncthreads();
    pass_r<true>(last, local, 2 * kRadix - 1, t, t, tw, ar);
    __syncthreads();
    tile_out(Out<true, W>{y + off + ((size_t)c << logH), f, 0}, local, smem);
  } else {
    const size_t half = off + ((size_t)c << logH);
    tile_in(In<kMul, W>{x + half, kMul ? b + half : nullptr, f, 1}, local, smem);
    __syncthreads();
    pass_r<false>(last, local, 2 * kRadix - 1, t, t, tw, ar);
    __syncthreads();
    pass<kRadix, false>(local, kRadix - 1, t, t, tw, ar);
    cluster.sync();
    pass<kRadix, false>(cross, 0, halves(cluster, smem, c), Out<false, W>{y + off, f, 1}, tw,
                        ar);
    cluster.sync();  // the peer reads this block's tile until here
  }
}

// The fused product at logn 14-15 (rns_u32_polymul; see the note at the
// top): INTT(NTT(a) o NTT(b)) of one row pair a cluster of kC =
// 2^(logn - kLogPart) blocks, block c holding part c, 2^kLogPart words,
// of both rings in its tile (a's, then b's), row c of each ring's
// (kC, N/kC) view, whose local stage l is the ring's l + log kC.  Each
// forward pass runs both rings' items through one loop body (pass2); the
// forwards' last pass leaves canonical residues in the tile, and the
// inverse's first pass, on the same items, reads their product; the
// inverse ends as cluster_ring's does, n^-1 on store.  y may alias a or
// b: every word of both is read before the cluster barrier that precedes
// any store.
template <int kC, class W, class F>
__global__ void __launch_bounds__(kThreads, kBlocks)
cluster_product(const W* a, const W* b, W* y, int logn, F fwd, F inv, int xnp) {
  extern __shared__ uint32_t smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), logC = logn - kLogPart;
  const int at_b = padded_words(kLogPart);  // b's part, after a's in each tile
  const int last = logn - 2 * kRadix;       // stages in the pass of 10 .. logn - 1
  const size_t ring = blockIdx.x / kC, off = ring << logn;
  const Ring f = fwd.at(ring);
  const Cross<kC> cross{RowGeo{0, logn, 0, 1, xnp}, c};
  const RowGeo local{logC, kLogPart, c, 1, xnp};
  const GlobalTw ftw{f.tw}, itw{inv.at(ring).tw};
  const Lazy ar{f.q, 2 * f.q};
  const auto in = [&](int r) { return In<false, W>{(r ? b : a) + off, nullptr, f, 1}; };
  const auto peers = [&](int r) { return parts<kC>(cluster, smem, c, r ? at_b : 0); };
  const auto tile = [&](int r) { return Tile{smem + (r ? at_b : 0)}; };
  const auto canon = [&](int r) { return Canon{smem + (r ? at_b : 0), ar}; };
  cluster.sync();  // the peers' tiles are there to be written
  pass2<kRadix, true>(cross, 0, in, peers, ftw, ar);
  cluster.sync();
  pass2<kRadix, true>(local, kRadix - logC, tile, tile, ftw, ar);
  __syncthreads();
  if (last == kRadix)  // five stages at logn 15, four at 14
    pass2<kRadix, true>(local, 2 * kRadix - logC, tile, canon, ftw, ar);
  else
    pass2<kRadix - 1, true>(local, 2 * kRadix - logC, tile, canon, ftw, ar);
  // a ring's items are a multiple of kThreads: each thread's items below
  // are those whose words it stored above, so no barrier
  pass_r<false>(last, local, 2 * kRadix - logC, Product{smem, at_b, f}, tile(0), itw, ar);
  __syncthreads();
  pass<kRadix, false>(local, kRadix - logC, tile(0), tile(0), itw, ar);
  cluster.sync();
  pass<kRadix, false>(cross, 0, peers(0), Out<false, W>{y + off, f, 1}, itw, ar);
  cluster.sync();  // the peers read this block's tile until here
}

// log2 words of a block's tile for rows of 2^logB words.
int tile_log(int logB) { return logB > kLogTile ? logB : kLogTile; }

// Whether a transform of this split runs on the clusters (cluster_ring).
bool clustered(int logn, int logA) { return logA == 0 && logn >= kLogCluster; }

// Shapes the tiles cover: rows of 2^6 to 2^15 words (two passes at
// least), and a column tile of whole columns that is no wider than a row.
bool shape_ok(long long batch, int logn, int logA) {
  const int logB = logn - logA;
  if (batch <= 0 || logA < 0 || logB <= kRadix || logB > kLogTileLarge) return false;
  const int logW = tile_log(logB);
  if (logA > 0 && (logA > logW || logW > logn)) return false;
  // every row index and grid size fits an int
  return batch < (1LL << 31) && (batch << logA) < (1LL << 31) &&
         ((batch << logn) >> logW) < (1LL << 31) &&
         (!clustered(logn, logA) || batch * kCluster < (1LL << 31));
}

int grid_cols(long long batch, int logn, int logA) {
  const int logB = logn - logA;
  return (int)(batch << (logB - (tile_log(logB) - logA)));
}

// Shared memory of a column block: its padded tile, then (past one
// pass) the column table's entries.
int col_bytes(int logW, int logA) {
  return 4 * padded_words(logW) + (logA > kRadix ? 8 << logA : 0);
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

// A whole-ring transform on the clusters: kMul, INTT(x o b); otherwise
// NTT(x) (kFwd) or INTT(x), b unused.
template <bool kFwd, bool kMul, class W, class F>
int ring_launch(const W* x, const W* b, W* y, long long batch, int logn, F f, int xnp,
                cudaStream_t st) {
  const int bytes = 4 * padded_words(logn - 1);
  if (int rc = fit_smem(cluster_ring<kFwd, kMul, W, F>, bytes)) return rc;
  cluster_ring<kFwd, kMul, W, F><<<(int)(batch * kCluster), kThreads, bytes, st>>>(
      x, b, y, logn, f, xnp);
  return launch_status();
}

// The fused product on clusters of kC blocks, each block's tile a part of
// 2^kLogPart words of each ring: launched by cudaLaunchKernelEx with a
// cluster attribute, the cluster's size being a template argument.
template <int kC, class W, class F>
int product_launch(const W* a, const W* b, W* y, long long batch, int logn, F fwd, F inv,
                   int xnp, cudaStream_t st) {
  const int bytes = 8 * padded_words(kLogPart);
  const auto k = cluster_product<kC, W, F>;
  if (int rc = fit_smem(k, bytes)) return rc;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kC;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * kC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, a, b, y, logn, fwd, inv, xnp);
  return e == cudaSuccess ? launch_status() : (int)e;
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

template <class W, class F>
int forward(const W* x, W* y, long long batch, int logn, int logA, F f, int xnp,
            cudaStream_t st) {
  if (clustered(logn, logA))
    return ring_launch<true, false, W>(x, nullptr, y, batch, logn, f, xnp, st);
  const int logB = logn - logA, logW = tile_log(logB);
  if (logA > 0) {
    const int bytes = col_bytes(logW, logA);
    if (int rc = fit_smem(cols<true, W, F>, bytes)) return rc;
    cols<true, W, F><<<grid_cols(batch, logn, logA), kThreads, bytes, st>>>(
        x, y, logn, logA, logW - logA, f, xnp);
    if (int rc = launch_status()) return rc;
  }
  const int log_rows = rows_log(logA, logB, f), bytes = 4 * padded_words(logB + log_rows);
  if (int rc = fit_smem(rows<true, false, W, F>, bytes)) return rc;
  rows<true, false, W, F><<<grid_rows(batch, logA, log_rows), kThreads, bytes, st>>>(
      logA > 0 ? y : x, nullptr, y, (int)(batch << logA), logA, logB, log_rows, f, logA == 0,
      0, xnp);
  return launch_status();
}

// kMul: INTT(a o b); otherwise INTT(a) (b unused).
template <bool kMul, class W, class F>
int inverse(const W* a, const W* b, W* y, long long batch, int logn, int logA, F f, int xnp,
            cudaStream_t st) {
  if (clustered(logn, logA))
    return ring_launch<false, kMul, W>(a, b, y, batch, logn, f, xnp, st);
  const int logB = logn - logA, logW = tile_log(logB);
  const int log_rows = rows_log(logA, logB, f), bytes = 4 * padded_words(logB + log_rows);
  if (int rc = fit_smem(rows<false, kMul, W, F>, bytes)) return rc;
  rows<false, kMul, W, F><<<grid_rows(batch, logA, log_rows), kThreads, bytes, st>>>(
      a, b, y, (int)(batch << logA), logA, logB, log_rows, f, 1, logA == 0, xnp);
  if (int rc = launch_status()) return rc;
  if (logA > 0) {
    const int bytes = col_bytes(logW, logA);
    if (int rc = fit_smem(cols<false, W, F>, bytes)) return rc;
    cols<false, W, F><<<grid_cols(batch, logn, logA), kThreads, bytes, st>>>(
        y, y, logn, logA, logW - logA, f, xnp);
  }
  return launch_status();
}

OneModulus one_modulus(const uint64_t* tw, uint32_t q, uint32_t one_s, uint32_t n_inv = 0,
                       uint32_t n_inv_s = 0) {
  return OneModulus{Ring{tw, q, one_s, n_inv, n_inv_s, 0, 0}};
}

// The stacked packed tables of an RNS schedule: 2^logn entries per
// modulus for X^N + 1, 2^(logn-1) for X^N - 1.
Stacked rns(const int* mod_idx, int shift, int logn, const uint64_t* tw, const uint64_t* consts,
            int xnp) {
  return Stacked{mod_idx, shift, tw, xnp ? 1LL << logn : 1LL << (logn - 1), consts};
}

// The RNS entries on words of type W: the schedule checked, then the
// kernels.
template <class W>
int rns_forward(int device, const W* x, W* y, long long batch, int logn, int logA,
                const int* mod_idx, long long entries, int shift, const uint64_t* tw,
                const uint64_t* consts, int xnp, void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, rns(mod_idx, shift, logn, tw, consts, xnp), xnp,
                 (cudaStream_t)stream);
}

// kMul: INTT(a o b) (the polymul's inverse); otherwise INTT(a).
template <bool kMul, class W>
int rns_inverse(int device, const W* a, const W* b, W* y, long long batch, int logn, int logA,
                const int* mod_idx, long long entries, int shift, const uint64_t* tw,
                const uint64_t* consts, int xnp, void* stream) {
  if (!schedule_ok(batch, entries, shift)) return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<kMul>(a, b, y, batch, logn, logA, rns(mod_idx, shift, logn, tw, consts, xnp),
                       xnp, (cudaStream_t)stream);
}

// INTT(NTT(a) o NTT(b)) in one launch (cluster_product), only where a
// transform runs on the clusters (logn 14-15, logA 0); fwd_tw and inv_tw
// are the stacked packed forward and inverse tables.
template <class W>
int rns_product(int device, const W* a, const W* b, W* y, long long batch, int logn, int logA,
                const int* mod_idx, long long entries, int shift, const uint64_t* fwd_tw,
                const uint64_t* inv_tw, const uint64_t* consts, int xnp, void* stream) {
  if (!schedule_ok(batch, entries, shift) || !clustered(logn, logA))
    return (int)cudaErrorInvalidValue;
  if (int rc = begin(device, batch, logn, logA)) return rc;
  if ((batch << (logn - kLogPart)) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Stacked fwd = rns(mod_idx, shift, logn, fwd_tw, consts, xnp);
  const Stacked inv = rns(mod_idx, shift, logn, inv_tw, consts, xnp);
  const cudaStream_t st = (cudaStream_t)stream;
  if (logn - kLogPart == 2) return product_launch<4>(a, b, y, batch, logn, fwd, inv, xnp, st);
  return product_launch<2>(a, b, y, batch, logn, fwd, inv, xnp, st);
}

}  // namespace
}  // namespace merge_u32

using namespace merge_u32;

// Every entry: pointers to contiguous (batch, 2^logn) int64 lanes holding
// u32 words on card `device` (only the low 32 bits of each input word are
// read), or for the *_i32 entries int32 lanes (4-byte words, each
// reduced mod q as read; the output canonical residues < 2^30), launches
// on `stream`, allocates nothing, does not synchronise,
// and returns the cudaError_t of its launches (0 = none).  logA is log2 of
// the column count A of the split (hopper_merge32.split); x may equal y.
// `tw` is a packed table: one int64 word per entry of the bit-reversed
// table, the entry in the low 32 bits and its Shoup companion
// floor(w * 2^32 / q) in the high 32 (hopper_merge32.packed_tables).
// The merge_u32_* entries take one modulus: its packed table and its
// numbers.  The rns_u32_* entries take an int32 schedule of batch >> shift
// moduli (ring i uses modulus mod_idx[i >> shift], every entry in
// [0, mod_count)), the stacked (mod_count, table) packed tables and the
// (mod_count, 6) constants of ops/rns.py's RNSMergePlan; each has a twin,
// rns_u32_*_i32, with the same arguments on int32 lanes.  rns_u32_polymul
// takes both the forward and the inverse packed tables, and only the
// shapes whose transforms run on the clusters (logn 14-15, log A 0); y
// may equal a or b there too.
extern "C" {

int merge_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch,
                      int logn, int logA, const uint64_t* tw, uint32_t q, uint32_t one_s,
                      int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return forward(x, y, batch, logn, logA, one_modulus(tw, q, one_s), xnp,
                 (cudaStream_t)stream);
}

int merge_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch,
                      int logn, int logA, const uint64_t* tw, uint32_t q, uint32_t one_s,
                      uint32_t n_inv, uint32_t n_inv_s, int xnp, void* stream) {
  if (int rc = begin(device, batch, logn, logA)) return rc;
  return inverse<false, uint64_t>(x, nullptr, y, batch, logn, logA,
                                  one_modulus(tw, q, one_s, n_inv, n_inv_s), xnp,
                                  (cudaStream_t)stream);
}

int rns_u32_forward(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* consts, int xnp, void* stream) {
  return rns_forward(device, x, y, batch, logn, logA, mod_idx, entries, shift, tw, consts, xnp,
                     stream);
}

int rns_u32_inverse(int device, const uint64_t* x, uint64_t* y, long long batch, int logn,
                    int logA, const int* mod_idx, long long entries, int shift,
                    const uint64_t* tw, const uint64_t* consts, int xnp, void* stream) {
  return rns_inverse<false>(device, x, static_cast<const uint64_t*>(nullptr), y, batch, logn,
                            logA, mod_idx, entries, shift, tw, consts, xnp, stream);
}

int rns_u32_polymul_inverse(int device, const uint64_t* fa, const uint64_t* fb, uint64_t* y,
                            long long batch, int logn, int logA, const int* mod_idx,
                            long long entries, int shift, const uint64_t* tw,
                            const uint64_t* consts, int xnp, void* stream) {
  return rns_inverse<true>(device, fa, fb, y, batch, logn, logA, mod_idx, entries, shift, tw,
                           consts, xnp, stream);
}

int rns_u32_forward_i32(int device, const uint32_t* x, uint32_t* y, long long batch, int logn,
                        int logA, const int* mod_idx, long long entries, int shift,
                        const uint64_t* tw, const uint64_t* consts, int xnp, void* stream) {
  return rns_forward(device, x, y, batch, logn, logA, mod_idx, entries, shift, tw, consts, xnp,
                     stream);
}

int rns_u32_inverse_i32(int device, const uint32_t* x, uint32_t* y, long long batch, int logn,
                        int logA, const int* mod_idx, long long entries, int shift,
                        const uint64_t* tw, const uint64_t* consts, int xnp, void* stream) {
  return rns_inverse<false>(device, x, static_cast<const uint32_t*>(nullptr), y, batch, logn,
                            logA, mod_idx, entries, shift, tw, consts, xnp, stream);
}

int rns_u32_polymul_inverse_i32(int device, const uint32_t* fa, const uint32_t* fb,
                                uint32_t* y, long long batch, int logn, int logA,
                                const int* mod_idx, long long entries, int shift,
                                const uint64_t* tw, const uint64_t* consts, int xnp,
                                void* stream) {
  return rns_inverse<true>(device, fa, fb, y, batch, logn, logA, mod_idx, entries, shift, tw,
                           consts, xnp, stream);
}

int rns_u32_polymul(int device, const uint64_t* a, const uint64_t* b, uint64_t* y,
                    long long batch, int logn, int logA, const int* mod_idx, long long entries,
                    int shift, const uint64_t* fwd_tw, const uint64_t* inv_tw,
                    const uint64_t* consts, int xnp, void* stream) {
  return rns_product(device, a, b, y, batch, logn, logA, mod_idx, entries, shift, fwd_tw, inv_tw,
                     consts, xnp, stream);
}

int rns_u32_polymul_i32(int device, const uint32_t* a, const uint32_t* b, uint32_t* y,
                        long long batch, int logn, int logA, const int* mod_idx,
                        long long entries, int shift, const uint64_t* fwd_tw,
                        const uint64_t* inv_tw, const uint64_t* consts, int xnp, void* stream) {
  return rns_product(device, a, b, y, batch, logn, logA, mod_idx, entries, shift, fwd_tw, inv_tw,
                     consts, xnp, stream);
}

}  // extern "C"
