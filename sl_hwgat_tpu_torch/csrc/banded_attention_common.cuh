// Shared by the banded-attention forward and backward kernels (sm_90a).
//
// Layout: token-major (P, F * V, kDH) in T = float or __nv_bfloat16, one
// plane per (group, head); frame f holds tokens f*V .. f*V + V - 1 (V <= 32).
// Query joint i of frame f attends to the keys of frames f-1, f and f+1
// under the band's three planes [prev | self | next]: bit j of `rows[p][i]`
// is set where key joint j of that frame is an edge. The prev plane is empty
// at f = 0 and the next plane at f = F - 1.
//
// Only the edges are visited: a masked entry of the plain version carries
// -1e4, whose softmax weight underflows to exactly 0.0 in f32 wherever the
// row has an edge (the host refuses bands with an edgeless row).
//
// A block owns frames_per_block(V) = 128 / V consecutive frames of one
// plane; one thread per query (forward, backward row phase) or key
// (backward column phase) token. Neighbour frames are staged as f32 rows in
// shared memory, so the keys a thread reads are broadcasts or short strided
// reads.
//
// Rounding follows sl_hwgat_tpu/ops/pallas_banded.py::_fwd_kernel_packed:
// every score is an f32 dot of the inputs times scale in f32; the softmax is
// f32; the self plane's probabilities are rounded to T before A.V, the
// prev/next ones are not. The backward recomputes A with the same code, so A
// is the same bit for bit in both passes and in both of its phases.

#pragma once

#include <math.h>

#include "window_attention_common.cuh"

namespace battn {

using wattn::from_float;
using wattn::load16;
using wattn::round_to;
using wattn::to_float;

constexpr int kDH = 16;
constexpr int kMaxV = 32;
constexpr int kThreads = 128;

__host__ __device__ __forceinline__ int frames_per_block(int v) { return kThreads / v; }

// Rows [r0, r0 + n) of a (rows, kDH) tensor in T -> f32 rows at dst, with
// coalesced 16-byte loads spread over the block.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long r0, int n,
                                      float* dst) {
  constexpr int kEpv = 16 / sizeof(T);
  const T* s = src + r0 * kDH;
  for (int e = threadIdx.x; e < n * kDH / kEpv; e += blockDim.x) {
    float t[kEpv];
    load16(s + e * kEpv, t);
    float4* d = reinterpret_cast<float4*>(dst + e * kEpv);
#pragma unroll
    for (int i = 0; i < kEpv / 4; ++i)
      d[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
  }
}

// Stage the frames [first, last] (clipped to [0, frames)) of a plane into the
// slots of `dst`, slot 0 being frame `first`.
template <typename T>
__device__ __forceinline__ void stage_frames(const T* __restrict__ plane, int first, int last,
                                             int frames, int v, float* dst) {
  const int lo = first < 0 ? 0 : first;
  const int hi = last >= frames ? frames - 1 : last;
  if (hi >= lo)
    stage<T>(plane, static_cast<long long>(lo) * v, (hi - lo + 1) * v,
             dst + (lo - first) * v * kDH);
}

// One token row of T in device memory -> kDH floats.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, float (&r)[kDH]) {
  constexpr int kEpv = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kDH / kEpv; ++c) load16(src + c * kEpv, r + c * kEpv);
}

__device__ __forceinline__ void copy_row(const float* __restrict__ src, float (&r)[kDH]) {
#pragma unroll
  for (int d4 = 0; d4 < kDH / 4; ++d4) {
    const float4 x = reinterpret_cast<const float4*>(src)[d4];
    r[4 * d4] = x.x; r[4 * d4 + 1] = x.y; r[4 * d4 + 2] = x.z; r[4 * d4 + 3] = x.w;
  }
}

// kDH floats -> one token row in device memory, with 16-byte stores.
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&r)[kDH]) {
#pragma unroll
  for (int d4 = 0; d4 < kDH / 4; ++d4)
    reinterpret_cast<float4*>(dst)[d4] =
        make_float4(r[4 * d4], r[4 * d4 + 1], r[4 * d4 + 2], r[4 * d4 + 3]);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ dst,
                                          const float (&r)[kDH]) {
#pragma unroll
  for (int c = 0; c < kDH / 8; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r[8 * c + 2 * i], r[8 * c + 2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(dst)[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// sum_d a[d] * b[d] in f32, in d order; `b` is an f32 row in shared memory.
// fmaf is exact in the order of its two factors, so the row and column
// phases, which hold the query and the key on opposite sides, get the same
// bits.
__device__ __forceinline__ float dot(const float (&a)[kDH], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < kDH / 4; ++d4) {
    const float4 x = reinterpret_cast<const float4*>(b)[d4];
    acc = fmaf(a[4 * d4], x.x, acc);
    acc = fmaf(a[4 * d4 + 1], x.y, acc);
    acc = fmaf(a[4 * d4 + 2], x.z, acc);
    acc = fmaf(a[4 * d4 + 3], x.w, acc);
  }
  return acc;
}

__device__ __forceinline__ void axpy(float a, const float* x, float (&acc)[kDH]) {
#pragma unroll
  for (int d4 = 0; d4 < kDH / 4; ++d4) {
    const float4 y = reinterpret_cast<const float4*>(x)[d4];
    acc[4 * d4] = fmaf(a, y.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(a, y.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(a, y.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(a, y.w, acc[4 * d4 + 3]);
  }
}

// The row's edge bits per plane, with the clip's ends cut.
struct RowBits {
  uint32_t p[3];
};

__device__ __forceinline__ RowBits row_bits(const uint32_t* __restrict__ rows, int i, int f,
                                            int frames) {
  return RowBits{{f > 0 ? __ldg(rows + i) : 0u, __ldg(rows + kMaxV + i),
                  f < frames - 1 ? __ldg(rows + 2 * kMaxV + i) : 0u}};
}

// Softmax statistics of one query row: the row max and the sum of
// exp(s - max) over its edges. `keys` points at the key slot of frame f-1;
// plane p's keys are slot p.
struct RowStats {
  float max;
  float sum;
};

__device__ __forceinline__ RowStats row_stats(const float (&qr)[kDH], const float* keys,
                                              const RowBits& b, int v, float scale) {
  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bits = b.p[p]; bits; bits &= bits - 1) {
      const int j = __ffs(bits) - 1;
      m = fmaxf(m, dot(qr, keys + (p * v + j) * kDH) * scale);
    }
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bits = b.p[p]; bits; bits &= bits - 1) {
      const int j = __ffs(bits) - 1;
      sum += expf(dot(qr, keys + (p * v + j) * kDH) * scale - m);
    }
  return RowStats{m, sum};
}

// The probability of one edge, from its score and the row's statistics.
__device__ __forceinline__ float prob(float s, const RowStats& st) {
  return expf(s - st.max) / st.sum;
}

}  // namespace battn
