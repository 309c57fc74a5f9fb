// The modmul-peak probe (sm_90a): a chain of canonical Shoup products in
// registers, the port's counterpart of the JAX package's
// gpuntt_tpu/utils/profiling.py measure_vpu_modmul_peak.
//
// It replaces no TPU kernel: the JAX probe is plain jnp, which XLA fuses
// into one elementwise loop.  Its plain PyTorch version cannot measure a
// peak here: every torch op is one memory-bound elementwise kernel, and
// a 64-bit Shoup product alone is some 29 of them.  So the chain is a
// kernel that keeps each word in a register for all `depth` products and
// touches device memory twice a word (one load, one store), whatever the
// depth.  The rate it reports (utils/profiling.measure_modmul_peak) is
// what the transforms' butterflies could reach at best.
//
//   shoup_chain_u64: y = x * w^depth mod q, each step exactly
//     ops/barrett.py shoup_mul64: hi = high word of x * w', r = x * w -
//     hi * q (mod 2^64), one conditional subtract of q; w' = floor(w *
//     2^64 / q), x and w below q < 2^63.
//   shoup_chain_u32: the same on 32-bit words (shoup_mul32), q < 2^31;
//     the int64 lanes hold u32 values and the kernel reads their low
//     word.
//
// Bound: operations.  A u64 product is some 13 32-bit multiply-adds on
// Hopper's 32-bit multiplier (__umul64hi and two 64-bit low products), a
// u32 one 3 multiplies.  At the probe's depths the two memory passes are
// a few percent of a launch.
// Each thread runs kWords independent chains, so the scheduler always
// has an independent product to start while one waits on a multiply.
// The store keeps the compiler from dropping the chain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // independent chains a thread

__device__ __forceinline__ uint64_t shoup(uint64_t x, uint64_t w, uint64_t ws, uint64_t q) {
  const uint64_t r = x * w - __umul64hi(x, ws) * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

// Block b takes kThreads * kWords consecutive words, thread t the words
// t, t + kThreads, ... of them (neighbouring threads on neighbouring
// words); the last block masks the ragged edge.
template <class Word>
__global__ void __launch_bounds__(kThreads)
    chain(const uint64_t* __restrict__ x, uint64_t* __restrict__ y, long long n, int depth,
          Word w, Word ws, Word q) {
  const long long base = (long long)blockIdx.x * (kThreads * kWords) + threadIdx.x;
  Word v[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long i = base + (long long)k * kThreads;
    v[k] = i < n ? (Word)x[i] : Word(0);
  }
#pragma unroll 4
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) v[k] = shoup(v[k], w, ws, q);
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long i = base + (long long)k * kThreads;
    if (i < n) y[i] = (uint64_t)v[k];
  }
}

int launch_status() {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e;
}

template <class Word>
int run(int device, const uint64_t* x, uint64_t* y, long long n, int depth, Word w, Word ws,
        Word q, void* stream) {
  const long long per_block = (long long)kThreads * kWords;
  const long long grid = (n + per_block - 1) / per_block;
  if (n <= 0 || depth < 0 || grid >= (1LL << 31) || q < 2 || w >= q)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  chain<Word><<<(int)grid, kThreads, 0, st>>>(x, y, n, depth, w, ws, q);
  return launch_status();
}

}  // namespace

extern "C" {

int shoup_chain_u64(int device, const uint64_t* x, uint64_t* y, long long n, int depth,
                    uint64_t w, uint64_t ws, uint64_t q, void* stream) {
  return run<uint64_t>(device, x, y, n, depth, w, ws, q, stream);
}

int shoup_chain_u32(int device, const uint64_t* x, uint64_t* y, long long n, int depth,
                    uint32_t w, uint32_t ws, uint32_t q, void* stream) {
  return run<uint32_t>(device, x, y, n, depth, w, ws, q, stream);
}

}  // extern "C"
