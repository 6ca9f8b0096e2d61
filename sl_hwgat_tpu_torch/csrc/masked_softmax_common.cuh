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
// Layout: per-unit scores (U, n, n), f32 or bf16 (upcast to f32 on load),
// n <= 64. A row is held by a group of kLanes lanes of a warp (8 for n <= 32,
// 16 for n <= 64), four columns a lane, so a warp takes 32 / kLanes rows at
// once. Which four, by n alone
// (so both kernels agree whatever their pointers): for n a multiple of 4,
// lane l of the group holds 4l .. 4l + 3 (16 contiguous bytes of f32, one
// load); for other even n (HGATE's 58), the pairs 2l, 2l + 1
// and 2l + 2 kLanes, 2l + 2 kLanes + 1 (rows of 58 floats are only 8-byte
// aligned); for odd n, l + kLanes c. The reductions run over the lane's
// four columns in order, then across the group by xor shuffles. Row masks
// are (2, n) 64-bit words, bit j = key token j.
//
// Both kernels take a block of kWarps warps over kMinRows / n whole units
// (at least one), whose mask planes the block looks up once per unit.

#pragma once

#include <math.h>

#include "window_attention_common.cuh"

namespace msoft {

using wattn::kNeg;

constexpr int kPer = 4;  // columns a lane holds
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinRows = 128;  // a block takes max(1, kMinRows / n) units

__host__ __device__ __forceinline__ int units_per_block(int n) {
  return n >= kMinRows ? 1 : kMinRows / n;
}

// The column maps above, chosen by n.
enum ColumnMap { kQuads, kPairs, kSingles };

__host__ __device__ __forceinline__ int column_map(int n) {
  return n % 4 == 0 ? kQuads : n % 2 == 0 ? kPairs : kSingles;
}

// The column of the c-th value of lane l of a row group.
template <int kLanes, int kMap>
__device__ __forceinline__ int column(int l, int c) {
  return kMap == kQuads ? kPer * l + c
         : kMap == kPairs ? 2 * l + (c & 1) + 2 * kLanes * (c >> 1)
                          : l + kLanes * c;
}

template <int kLanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row of raw scores `s` (this lane's columns column(l, c); entries at
// columns >= n are ignored) -> its probabilities `a` (0 at columns >= n):
//   prune: P0 = softmax(s), s[P0 > u] = 0, u read from device memory;
//   s[!allowed | (zero_quirk & s == 0)] = kNeg;  a = softmax(s).
// Returns bit c set where column(l, c) passes the gradient (the masked
// score still equals the raw one; the prune mask is not differentiated).
// Every lane of the warp calls it (the shuffles span the warp); a group
// with no row passes n and allowed = 0 and ignores the result.
template <int kLanes, int kMap>
__device__ __forceinline__ unsigned masked_softmax_row(const float (&s)[kPer], int l, int n,
                                                       unsigned long long allowed,
                                                       const float* __restrict__ prune_u,
                                                       int zero_quirk, float (&a)[kPer]) {
  unsigned pruned = 0u;
  if (prune_u != nullptr) {
    const float u = __ldg(prune_u);
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (column<kLanes, kMap>(l, c) < n) m = fmaxf(m, s[c]);
    m = group_max<kLanes>(m);
    float e[kPer], total = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      e[c] = column<kLanes, kMap>(l, c) < n ? expf(s[c] - m) : 0.f;
      total += e[c];
    }
    total = group_sum<kLanes>(total);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (column<kLanes, kMap>(l, c) < n && e[c] / total > u) pruned |= 1u << c;
  }

  unsigned pass = 0u;
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    a[c] = 0.f;
    if (j < n) {
      const float sp = ((pruned >> c) & 1u) ? 0.f : s[c];
      const bool keep = ((allowed >> j) & 1ull) && (!zero_quirk || sp != 0.f);
      a[c] = keep ? sp : kNeg;
      if (a[c] == s[c]) pass |= 1u << c;
      m = fmaxf(m, a[c]);
    }
  }
  m = group_max<kLanes>(m);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    a[c] = column<kLanes, kMap>(l, c) < n ? expf(a[c] - m) : 0.f;
    sum += a[c];
  }
  const float inv = 1.f / group_sum<kLanes>(sum);
#pragma unroll
  for (int c = 0; c < kPer; ++c) a[c] *= inv;
  return pass;
}

// This lane's columns of a row of n values at `row`, as f32 (0 beyond n).
// `vec`: the tensor is 16-byte aligned, so that quads (f32: 16 bytes, bf16:
// 8) and pairs (8, 4) load at once.
template <int kLanes, int kMap>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int l, int n, bool vec,
                                          float (&x)[kPer]) {
  if (vec && kMap == kQuads) {
    const float4 v = kPer * l < n ? __ldg(reinterpret_cast<const float4*>(row) + l)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
  if (vec && kMap == kPairs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      const float2 v = j < n ? __ldg(reinterpret_cast<const float2*>(row + j))
                             : make_float2(0.f, 0.f);
      x[2 * h] = v.x;
      x[2 * h + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    x[c] = j < n ? __ldg(row + j) : 0.f;
  }
}
template <int kLanes, int kMap>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ row, int l, int n,
                                          bool vec, float (&x)[kPer]) {
  if (vec && kMap != kSingles) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      float2 v = make_float2(0.f, 0.f);
      if (j < n) {
        const unsigned w = __ldg(reinterpret_cast<const unsigned*>(row + j));
        __nv_bfloat162 b;
        *reinterpret_cast<unsigned*>(&b) = w;
        v = __bfloat1622float2(b);
      }
      x[2 * h] = v.x;
      x[2 * h + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    x[c] = j < n ? __bfloat162float(row[j]) : 0.f;
  }
}

// x -> this lane's columns (those below n) of the row at `row`, in T.
template <int kLanes, int kMap>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int l, int n, bool vec,
                                           const float (&x)[kPer]) {
  if (vec && kMap == kQuads) {
    if (kPer * l < n) reinterpret_cast<float4*>(row)[l] = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
  if (vec && kMap == kPairs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      if (j < n) *reinterpret_cast<float2*>(row + j) = make_float2(x[2 * h], x[2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    if (j < n) row[j] = x[c];
  }
}
template <int kLanes, int kMap>
__device__ __forceinline__ void store_cols(__nv_bfloat16* __restrict__ row, int l, int n,
                                           bool vec, const float (&x)[kPer]) {
  if (vec && kMap != kSingles) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      if (j < n)
        *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(x[2 * h],
                                                                          x[2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    if (j < n) row[j] = __float2bfloat16_rn(x[c]);
  }
}

// The rows of one group of units: units [u0, u0 + count) of n tokens,
// count = units_per_block(n) but at the end, and the place of this lane: row
// group g of its warp, lane l of the group.
template <int kLanes>
struct BlockRows {
  long long u0;
  int count, n, g, l;

  // Group grp of `units` units.
  __device__ static __forceinline__ BlockRows of(long long grp, long long units, int n) {
    const int upb = units_per_block(n);
    const long long u0 = grp * upb;
    const int lane = threadIdx.x & 31;
    return BlockRows{u0, static_cast<int>(units - u0 < upb ? units - u0 : upb), n,
                     lane / kLanes, lane % kLanes};
  }

  // The mask plane of each unit into plane[0 .. count) (plain adjacency or
  // the shifted blocks' tail plane, as the window-attention kernels choose
  // it): once per unit, by the first threads of the block.
  __device__ __forceinline__ void planes(int* plane, int dual, const int* __restrict__ sel,
                                         int stack, int per_group, int groups,
                                         long long unit_offset) const {
    if (static_cast<int>(threadIdx.x) < count)
      plane[threadIdx.x] =
          wattn::mask_plane(u0 + threadIdx.x, dual, sel, stack, per_group, groups, unit_offset);
  }

  // The warp takes rows base + 0 .. base + 32 / kLanes - 1 (group g row
  // base + g) for base = first(), first() + kStep, ... while base < rows().
  __device__ __forceinline__ int first() const { return (threadIdx.x >> 5) * (32 / kLanes); }
  static constexpr int kStep = kWarps * (32 / kLanes);
  __device__ __forceinline__ int rows() const { return count * n; }

  // Row r's offset from the block's first unit, and its adjacency bits (0
  // for a row past the block's end, whose group computes nothing stored).
  __device__ __forceinline__ long long offset(int r) const {
    return (u0 * n + r) * static_cast<long long>(n);
  }
  __device__ __forceinline__ unsigned long long allowed(
      const unsigned long long* __restrict__ masks, const int* plane, int r) const {
    if (r >= rows()) return 0ull;
    const int unit = r / n;
    return __ldg(masks + plane[unit] * n + (r - unit * n));
  }
};

}  // namespace msoft
