// Shared by the window-attention forward and backward kernels (sm_90a).
//
// The backward recomputes the attention matrix A of the forward. Both call
// the same inlined code below for the scores, the prune, the masking and the
// softmax, so A and the set of entries it keeps are the same bit for bit in
// the two passes: a prune decision at the `u` boundary cannot flip between
// them, and the gradient is gated by exactly the entries the forward kept.
//
// Layout: token-major (U, n, DH) in T = float or __nv_bfloat16. Units of
// kN = 32 tokens run one warp per unit (lane i owns query row i, DH 32 or
// 64); units of up to kWideN = 64 tokens (HGATE: 58) run one block of 64
// threads per unit (thread i owns query row i, DH 64). The row code below is
// written once for both: templated on the unit's capacity, with the unit's
// token count n (== kN for 32-token units, where the guards fold away) and
// 32- or 64-bit row bitmasks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace wattn {

constexpr int kN = 32;
constexpr int kWideN = 64;
constexpr float kNeg = -10000.0f;

// Row bitmask of a unit of up to kCap tokens: bit j = key token j.
template <int kCap>
using RowBits = typename std::conditional<(kCap <= 32), uint32_t, unsigned long long>::type;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value a T-typed store of x would keep.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16 bytes of T at a 16-byte aligned p -> 16 / sizeof(T) floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The `rows` x DH rows of one unit -> f32 rows in shared memory, by
// kThreads threads (tid = 0 .. kThreads-1) with coalesced 16-byte loads and
// 16-byte stores.
template <typename T, int DH, int kThreads>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, float* dst, int tid,
                                           int rows) {
  constexpr int kEpv = 16 / sizeof(T);
  for (int e = tid; e < rows * DH / kEpv; e += kThreads) {
    float t[kEpv];
    load16(src + e * kEpv, t);
    float4* d = reinterpret_cast<float4*>(dst + e * kEpv);
#pragma unroll
    for (int i = 0; i < kEpv / 4; ++i)
      d[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
  }
}

// Query row `row` into registers, scaled in q's type (q * T(scale)).
template <typename T, int DH>
__device__ __forceinline__ void load_scaled_row(const T* __restrict__ row, float scale,
                                                float (&qr)[DH]) {
  constexpr int kEpv = 16 / sizeof(T);
  const float sc = round_to<T>(scale);
#pragma unroll
  for (int c = 0; c < DH / kEpv; ++c) load16(row + c * kEpv, qr + c * kEpv);
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(qr[d] * sc);
}

// Which of the two mask planes a unit attends under: from `sel` (one int per
// supertile of `stack` units) when given, else from the temporal-group phase.
__device__ __forceinline__ int mask_plane(long long unit, int dual, const int* __restrict__ sel,
                                          int stack, int per_group, int groups,
                                          long long unit_offset) {
  if (!dual) return 0;
  const long long tile = unit / stack;
  if (sel != nullptr) return sel[tile] != 0;
  return ((tile * stack + unit_offset) / per_group) % groups == groups - 1;
}

// One query row against the unit's keys (f32 rows in shared memory `ks`,
// n <= kCap of them):
//   s = qr . k_j (f32 sums);  prune: P0 = softmax(s), s[P0 > u] = 0;
//   s[!allowed | (zero_quirk & s == 0)] = kNeg;  e = exp(s - max s).
// Keys j >= n do not exist (padding): they take no part in either softmax
// and get e = 0, so a padded row equals an unpadded one.
// `allowed_row()` gives the row's adjacency bits; it is called after the
// scores, where the registers of the query row are free again. Writes e to
// `e` and its sum to `sum`: the probabilities are e[j] / sum, divided where
// the caller uses them (the forward after its V loads). Both keep the
// forward's register count at that of a kernel without the shared code.
// Returns the passthrough bits: bit j set where the masked score still
// equals the raw score, i.e. where the gradient flows (the prune mask itself
// is not differentiated).
template <int kCap, int DH, typename AllowedRow>
__device__ __forceinline__ RowBits<kCap> attention_row(const float (&qr)[DH], const float* ks,
                                                       int n, const float* __restrict__ prune_u,
                                                       AllowedRow allowed_row, int zero_quirk,
                                                       float (&e)[kCap], float& sum) {
  using Bits = RowBits<kCap>;
  float s[kCap];
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    s[j] = 0.f;
    if (j < n) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DH);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 kk = kr[d4];
        acc = fmaf(qr[4 * d4], kk.x, acc);
        acc = fmaf(qr[4 * d4 + 1], kk.y, acc);
        acc = fmaf(qr[4 * d4 + 2], kk.z, acc);
        acc = fmaf(qr[4 * d4 + 3], kk.w, acc);
      }
      s[j] = acc;
    }
  }

  // Train-time pruning over the raw scores of the unit.
  Bits pruned = 0;
  if (prune_u != nullptr) {
    const float u = __ldg(prune_u);
    float m = s[0];
#pragma unroll
    for (int j = 1; j < kCap; ++j)
      if (j < n) m = fmaxf(m, s[j]);
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kCap; ++j) {
      if (j < n) {
        e[j] = expf(s[j] - m);
        total += e[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCap; ++j)
      if (j < n && e[j] / total > u) pruned |= Bits(1) << j;
  }

  // Multiplicative adjacency + zero quirk, on the pruned scores.
  const Bits allowed = allowed_row();
  Bits pass = 0;
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j < n) {
      const float sp = ((pruned >> j) & 1u) ? 0.f : s[j];
      const bool keep = ((allowed >> j) & 1u) && (!zero_quirk || sp != 0.f);
      const float sm = keep ? sp : kNeg;
      if (sm == s[j]) pass |= Bits(1) << j;
      e[j] = sm;
    }
  }

  // Row softmax, left undivided.
  float m = e[0];
#pragma unroll
  for (int j = 1; j < kCap; ++j)
    if (j < n) m = fmaxf(m, e[j]);
  sum = 0.f;
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    if (j < n) {
      e[j] = expf(e[j] - m);
      sum += e[j];
    } else {
      e[j] = 0.f;
    }
  }
  return pass;
}

}  // namespace wattn
