// Shared by the masked-softmax forward and backward kernels (sm_90a).
//
// The backward recomputes the forward's probabilities A from the saved raw
// scores. Both call masked_softmax_row below, so A and the set of entries it
// keeps are the same bit for bit in the two passes: a prune decision at the
// `u` boundary cannot flip between them, and the gradient is gated by
// exactly the entries the forward kept. The masking rules are those of the
// window-attention kernels (window_attention_common.cuh, whose type helpers
// and mask-plane choice this header uses).
//
// Layout: per-unit scores (U, n, n), f32, n <= 64; one warp per row, lane l
// owning columns l and l + 32 (kCols = 1 for n <= 32, else 2). Row masks are
// (2, n) 64-bit words, bit j = key token j.

#pragma once

#include <math.h>

#include "window_attention_common.cuh"

namespace msoft {

using wattn::kNeg;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row of raw scores `s` (this lane's columns; entries at columns >= n
// are ignored) -> its probabilities `a` (0 at columns >= n):
//   prune: P0 = softmax(s), s[P0 > u] = 0, u read from device memory;
//   s[!allowed | (zero_quirk & s == 0)] = kNeg;  a = softmax(s).
// Returns bit c set where column lane + 32c passes the gradient (the masked
// score still equals the raw one; the prune mask is not differentiated).
template <int kCols>
__device__ __forceinline__ unsigned masked_softmax_row(const float (&s)[kCols], int lane, int n,
                                                       unsigned long long allowed,
                                                       const float* __restrict__ prune_u,
                                                       int zero_quirk, float (&a)[kCols]) {
  unsigned pruned = 0u;
  if (prune_u != nullptr) {
    const float u = __ldg(prune_u);
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < n) m = fmaxf(m, s[c]);
    m = warp_max(m);
    float e[kCols], total = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      e[c] = lane + 32 * c < n ? expf(s[c] - m) : 0.f;
      total += e[c];
    }
    total = warp_sum(total);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < n && e[c] / total > u) pruned |= 1u << c;
  }

  unsigned pass = 0u;
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    a[c] = 0.f;
    if (j < n) {
      const float sp = ((pruned >> c) & 1u) ? 0.f : s[c];
      const bool keep = ((allowed >> j) & 1ull) && (!zero_quirk || sp != 0.f);
      a[c] = keep ? sp : kNeg;
      if (a[c] == s[c]) pass |= 1u << c;
      m = fmaxf(m, a[c]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    a[c] = lane + 32 * c < n ? expf(a[c] - m) : 0.f;
    sum += a[c];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int c = 0; c < kCols; ++c) a[c] = a[c] / sum;
  return pass;
}

// The row's adjacency bits: plane 0 (adj) or 1 (the shifted blocks' tail
// plane) of the row's unit, chosen as the window-attention kernels choose it.
__device__ __forceinline__ unsigned long long row_mask(const unsigned long long* __restrict__ masks,
                                                       long long unit, int i, int n, int dual,
                                                       const int* __restrict__ sel, int stack,
                                                       int per_group, int groups,
                                                       long long unit_offset) {
  const int plane = wattn::mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset);
  return __ldg(masks + plane * n + i);
}

}  // namespace msoft
