// The merge network in registers: the pass that the row and column
// kernels of merge_u32.cu, the kernels of merge_u64_large.cu and the
// column kernels of fourstep.cu share, and the order of their passes.
//
// A pass runs kR consecutive stages l0 .. l0 + kR - 1 of a merge network
// on work items of 2^kR words: the words that one butterfly group of
// stage l0 combines over those kR stages.  Stage l pairs words t =
// N >> (l + 1) apart, so an item's words lie T = N >> (l0 + kR) apart and
// stage l0 + s pairs its registers 2^(kR - 1 - s) apart.  The item's
// group at stage l0 has heap index G in the bit-reversed table (the
// kernels compute G once per item: 2^l0 + group for X^N + 1, the group
// for X^N - 1, shifted by the row's place in a split ring); subgroup m of
// stage l0 + s then reads entry (G << s) + m, so an item reads the
// 2^kR - 1 entries of one subtree of the table's heap.
//
// W is the word (uint32_t or uint64_t); Ar holds the modulus and runs the
// lazy butterflies on W (ct: Cooley-Tukey, gs: Gentleman-Sande), Tw maps a
// table index to that entry's twiddle, in whatever form Ar takes.

#pragma once

namespace radix {

// Stage kS of a pass, then (forward) the stages after it or (inverse)
// the stages before it: a template per stage, so that every register
// index is a constant and the item's words stay in registers.
template <int kR, int kS, bool kFwd, class W, class Ar, class Tw>
__device__ __forceinline__ void stages(W (&v)[1 << kR], int G, const Ar& ar, const Tw& tw) {
  constexpr int h = 1 << (kR - 1 - kS);
#pragma unroll
  for (int m = 0; m < (1 << kS); ++m) {
    const auto w = tw((G << kS) + m);
#pragma unroll
    for (int u = 0; u < h; ++u) {
      if (kFwd)
        ar.ct(v[2 * h * m + u], v[2 * h * m + u + h], w);
      else
        ar.gs(v[2 * h * m + u], v[2 * h * m + u + h], w);
    }
  }
  if constexpr (kFwd && kS + 1 < kR) stages<kR, kS + 1, kFwd>(v, G, ar, tw);
  if constexpr (!kFwd && kS > 0) stages<kR, kS - 1, kFwd>(v, G, ar, tw);
}

// The kR stages of a pass on one item: CT stages upward (forward), GS
// stages downward (inverse).
template <int kR, bool kFwd, class W, class Ar, class Tw>
__device__ __forceinline__ void network(W (&v)[1 << kR], int G, const Ar& ar, const Tw& tw) {
  stages<kR, kFwd ? 0 : kR - 1, kFwd>(v, G, ar, tw);
}

// A pass of 1 .. kR stages whose count r is known only at run time (a
// constant r folds to one call): `p.template run<r, kIn, kOut>(l0)`.
template <int kR, bool kIn, bool kOut, class P>
__device__ __forceinline__ void run_r(int r, int l0, const P& p) {
  if constexpr (kR > 1) {
    if (r < kR) {
      run_r<kR - 1, kIn, kOut>(r, l0, p);
      return;
    }
  }
  p.template run<kR, kIn, kOut>(l0);
}

// The logN <= 3 kR stages of a network as ceil(logN / kR) passes of at
// most kR stages, the short one first forward and last inverse, a
// __syncthreads between two.  `p.template run<r, kIn, kOut>(l0)` runs
// the pass of stages l0 .. l0 + r - 1 over the block's items: the first
// pass reads the kernel's input (kIn), the last writes its output
// (kOut), the others read and write the block's tile.  At most three
// passes, written out: no loop counter to hold.
template <int kR, bool kFwd, class P>
__device__ __forceinline__ void passes(int logN, const P& p) {
  const int np = (logN + kR - 1) / kR, sr = logN - (np - 1) * kR;
  if (np == 1) {
    run_r<kR, true, true>(sr, 0, p);
    return;
  }
  run_r<kR, true, false>(kFwd ? sr : kR, kFwd ? 0 : logN - kR, p);
  if (np == 3) {
    __syncthreads();
    p.template run<kR, false, false>(sr);
  }
  __syncthreads();
  run_r<kR, false, true>(kFwd ? kR : sr, kFwd ? logN - kR : 0, p);
}

// Word kk of an item whose word 0 is tile word p and whose words lie S
// apart, in a tile padded with one spare word after every 2^kPad: the
// offset from the padded place of p.  Exact when (p mod 2^kPad) +
// (kk S mod 2^kPad) < 2^kPad for every kk, which holds for every item
// the kernels form (S a multiple of 2^kPad, or S a power of two below it
// with p mod 2^kPad < S and the item inside one aligned run of 2^kPad S).
template <int kPad>
__device__ __forceinline__ int padded_step(int kk, int S) {
  return kk * S + ((kk * S) >> kPad);
}

template <int kPad>
__device__ __forceinline__ int padded(int p) {
  return p + (p >> kPad);
}

}  // namespace radix
