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
// A block owns consecutive frames of one plane, one thread per query
// (forward, backward row phase) or key (backward column phase) token. The
// rows it reads are staged in T by cp.async with swizzled 16-byte chunks
// (Staged), so the rows a quarter-warp reads fall on distinct banks.
//
// Rounding follows sl_hwgat_tpu/ops/pallas_banded.py::_fwd_kernel_packed:
// every score is an f32 dot of the inputs (in d order) times scale in f32;
// the softmax is f32, its max then its sum of exp(s - max) over the row's
// edges in (plane, joint) order, A = exp(s - max) / sum; the self plane's
// probabilities are rounded to T before A.V, the prev/next ones are not.
// The backward recomputes A with the same arithmetic, so A is the same bit
// for bit in both passes and in both of its phases.

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

// 16 bytes from device memory into shared memory without a register or a
// wait (cp.async, sm_80 and later); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Wait for this thread's copies; a __syncthreads() after it shows all of the
// block's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Staged token rows of kDH elements of T in shared memory: chunk c (16
// bytes) of row r sits at chunk c ^ swizzle(r) of the row, so that the same
// chunk of eight consecutive rows covers all 32 banks.
template <typename T>
struct Staged {
  static constexpr int kChunks = kDH * static_cast<int>(sizeof(T)) / 16;  // 4 (f32), 2 (bf16)
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));           // elements per chunk
  static constexpr int kShift = kChunks == 4 ? 1 : 2;

  __device__ static __forceinline__ int chunk(int r, int c) {
    return r * kChunks + (c ^ ((r >> kShift) & (kChunks - 1)));
  }

  // Row r -> kDH floats.
  __device__ static __forceinline__ void row(const uint4* rows, int r, float (&x)[kDH]) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      load16(reinterpret_cast<const T*>(rows + chunk(r, c)), x + c * kEpc);
  }

  // a . row r in f32, in d order, a chunk at a time.
  __device__ static __forceinline__ float dot(const float (&a)[kDH], const uint4* rows, int r) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float t[kEpc];
      load16(reinterpret_cast<const T*>(rows + chunk(r, c)), t);
#pragma unroll
      for (int e = 0; e < kEpc; ++e) acc = fmaf(a[c * kEpc + e], t[e], acc);
    }
    return acc;
  }

  // row a of `ra` . row b of `rb`, in d order.
  __device__ static __forceinline__ float dot(const uint4* ra, int a, const uint4* rb, int b) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float s[kEpc], t[kEpc];
      load16(reinterpret_cast<const T*>(ra + chunk(a, c)), s);
      load16(reinterpret_cast<const T*>(rb + chunk(b, c)), t);
#pragma unroll
      for (int e = 0; e < kEpc; ++e) acc = fmaf(s[e], t[e], acc);
    }
    return acc;
  }

  // acc += w * row r.
  __device__ static __forceinline__ void axpy(float w, const uint4* rows, int r,
                                              float (&acc)[kDH]) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float t[kEpc];
      load16(reinterpret_cast<const T*>(rows + chunk(r, c)), t);
#pragma unroll
      for (int e = 0; e < kEpc; ++e) acc[c * kEpc + e] = fmaf(w, t[e], acc[c * kEpc + e]);
    }
  }

  // Frames [first, last] (clipped to [0, frames)) of a plane into rows
  // starting at `dst`, frame `first` at row 0, by cp.async.
  __device__ static __forceinline__ void stage(const T* __restrict__ plane, int first, int last,
                                               int frames, int nv, uint4* dst) {
    const int lo = first < 0 ? 0 : first;
    const int hi = last >= frames ? frames - 1 : last;
    if (hi < lo) return;
    const int r0 = (lo - first) * nv;
    const T* src = plane + static_cast<long long>(lo) * nv * kDH;
    const int n = (hi - lo + 1) * nv * kChunks;
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async16(dst + chunk(r0 + e / kChunks, e % kChunks), src + e * kEpc);
  }
};

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

}  // namespace battn
