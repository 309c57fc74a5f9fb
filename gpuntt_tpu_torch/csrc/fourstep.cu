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
// smaller).  It reads them as one contiguous run and stores them
// transposed into shared memory as an (n1, T) tile whose rows are T + 1
// words apart, so that neither the transposing store nor the column
// stages meet bank conflicts.  After the stages each of the n1 tile rows
// is twisted and written as T consecutive words of the (n1, n2) output.
//
// Bound: each launch reads and writes the ring once; at u64 2^24 x 1
// (n1 = 256) that is 256 MiB, 0.080 ms at 3.35 TB/s, against log n1 / 2
// + 2 Shoup products per word (2^24 * 6 * 16 32-bit multiplies at 67 T/s:
// 0.024 ms).  So the function is bound by device memory; the launches, as
// merge_u64_large.cu's K7, are held by per-stage barriers and
// shared-memory latency.  Tensor cores, TMA and clusters are not used.
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

#include "fourstep.cuh"

namespace fourstep {
namespace {

constexpr int kThreads = 256;

// log2 words of the largest tile: 32 KiB of the word type.
template <class W>
constexpr int log_tile() {
  return sizeof(W) == 8 ? 12 : 13;
}

// Block = (ring, tile of 2^logT rows of its (n2, n1) matrix); x -> y.
// Reduce and transpose on load, column stages, twist on store.
template <class W, bool kFwd, class F>
__global__ void __launch_bounds__(kThreads)
cols(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, int log1, int log2, int logT,
     int logTw, F fs) {
  extern __shared__ uint64_t smem[];
  W* s = reinterpret_cast<W*>(smem);
  const int tiles_log = log2 - logT, pitch = (1 << logT) + 1;
  const size_t ring = blockIdx.x >> tiles_log;
  const Ring f = fs.at(ring);
  const W q = (W)f.q, one_s = (W)f.one_s;
  const int j0 = (int)(blockIdx.x & ((1u << tiles_log) - 1)) << logT;
  const size_t base = ring << (log1 + log2);
  const int words = 1 << (log1 + logT), amask = (1 << log1) - 1, cmask = (1 << logT) - 1;
  const uint64_t* xt = x + base + ((size_t)j0 << log1);
  for (int e = threadIdx.x; e < words; e += kThreads)
    s[(e & amask) * pitch + (e >> log1)] = reduce_any((W)xt[e], q, one_s);
  __syncthreads();
  if (kFwd)
    ct_tile<kThreads>(s, log1, logT, pitch, f.tw, f.tws, q);
  else
    gs_tile<kThreads>(s, log1, logT, pitch, f.tw, f.tws, q);
  uint64_t* yt = y + base + j0;
  for (int e = threadIdx.x; e < words; e += kThreads) {
    const int a = e >> logT, c = e & cmask;
    yt[((size_t)a << log2) + c] =
        twist(s[a * pitch + c], a, j0 + c, log1, logTw, f.wt, f.wts, f.ws, f.wss, q);
  }
}

// Shapes the kernels cover: n1 = 2..512 columns, rows of n2 = 2^1..2^30
// words, a tile of T <= n2 rows within 32 KiB, a W tile Tw <= n2, and a
// grid within 2^31 blocks.
template <class W>
bool shape_ok(long long batch, int log1, int log2, int logT, int logTw) {
  return batch > 0 && log1 >= 1 && log1 <= 9 && log2 >= 1 && log2 <= 30 && logT >= 0 &&
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
  // at most 36 KiB (u64, n1 = 512): under the 48 KB static limit
  const int bytes = (int)sizeof(W) * (((1 << logT) + 1) << log1);
  cols<W, kFwd, F><<<(int)(batch << (log2 - logT)), kThreads, bytes, st>>>(
      x, y, log1, log2, logT, logTw, f);
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
