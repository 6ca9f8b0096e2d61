// Shared by the window-attention kernels that read and write the TPU layouts
// of the kernel bench in place (sm_90a): the forward (window_attention_layout.cu)
// and the backward (window_attention_layout_bwd.cu), 32-token units with
// DH 64.
//
// Every layout is a strided view of 32-token units: unit u = (a, b, s), with
// u = (a * B + b) * S + s, lies at a * sa + b * sb + s * ss, and inside it
// either the DH features of a token are contiguous ("rows": token stride ld;
// the row-major tiles, the lane pairs) or the 32 tokens of a feature are
// contiguous ("columns": feature stride ld; the transposed tiles, the tscore
// supertiles, the widened planes). ops/window_attention.py::unit_view
// describes each operand so.
//
// A columns operand is staged by cp.async as DH rows of 32 tokens (64 B in
// bf16, 128 B in f32: 4 or 8 16-byte chunks), each row padded by 16 bytes,
// so that reading 8 consecutive rows at one chunk (ldmatrix) or one token of
// every row (lane i, token i) meets no bank conflicts.

#pragma once

#include "window_attention_common.cuh"
#include "window_attention_wide.cuh"

namespace wattn {
namespace layout {

using bf16 = __nv_bfloat16;

constexpr int kDH = 64;

template <typename T> constexpr int kEpc = 16 / static_cast<int>(sizeof(T));
// a columns operand: DH rows of 32 tokens, padded by 16 bytes
template <typename T> constexpr int kSP = kN + kEpc<T>;
template <typename T> constexpr int kColBytes = kDH * kSP<T> * static_cast<int>(sizeof(T));

// One operand's view: unit u = (a, b, s) at a * sa + b * sb + s * ss
// elements, its rows or columns ld elements apart.
struct View {
  long long sa, sb, ss, ld;
  int nb, ns;
};

// Unit u's first element (u < 2^31: 32-bit divisions; with 64-bit ones
// the bench's layout entries ran 3-10% longer, bench.ablate layout).
__device__ __forceinline__ long long unit_base(const View& w, long long u) {
  const unsigned uu = static_cast<unsigned>(u), ns = static_cast<unsigned>(w.ns),
                 nb = static_cast<unsigned>(w.nb), r = uu / ns;
  return static_cast<long long>(r / nb) * w.sa + static_cast<long long>(r % nb) * w.sb +
         static_cast<long long>(uu - r * ns) * w.ss;
}

// The unit's DH columns of 32 tokens, ld apart in device memory, into a
// shared tile of DH rows kSP apart, by cp.async in 16-byte chunks.
template <typename T>
__device__ __forceinline__ void stage_cols(const T* __restrict__ src, long long ld, T* dst,
                                           int lane) {
  constexpr int kChunks = kN / kEpc<T>;
#pragma unroll
  for (int c = lane; c < kDH * kChunks; c += 32) {
    const int d = c / kChunks, x = c % kChunks * kEpc<T>;
    wide::cp_async16(dst + d * kSP<T> + x, src + d * ld + x);
  }
}

// Staged bf16 k columns -> f32 rows DH apart (in place where `cols` is the
// start of `rows`): lane (p = lane % 16, h = lane / 16) reads tokens 2p and
// 2p + 1 of features 32h .. 32h + 31 as 32-bit words, all of them before
// the first write, then writes those features of rows 2p and 2p + 1, a
// 4-feature chunk a step, starting at chunk p + h (mod 8): the reads of a
// step fall in 32 distinct banks and every 8 lanes write 8 distinct 16-byte
// bank groups.
__device__ __forceinline__ void key_cols_to_rows(const void* cols_tile, float* ks, int lane) {
  constexpr int kWords = kSP<bf16> / 2;  // a staged column row, in 32-bit words
  const uint32_t* cols = static_cast<const uint32_t*>(cols_tile);
  const int p = lane & 15, h = lane >> 4;
  uint32_t w[32];
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[4 * s + e] = cols[(32 * h + 4 * ((s + p + h) & 7) + e) * kWords + p];
  __syncwarp();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float2 f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 b;
      *reinterpret_cast<uint32_t*>(&b) = w[4 * s + e];
      f[e] = __bfloat1622float2(b);
    }
    float* row = ks + 2 * p * kDH + 32 * h + 4 * ((s + p + h) & 7);
    *reinterpret_cast<float4*>(row) = make_float4(f[0].x, f[1].x, f[2].x, f[3].x);
    *reinterpret_cast<float4*>(row + kDH) = make_float4(f[0].y, f[1].y, f[2].y, f[3].y);
  }
}

// Query row `lane` of staged columns into registers, scaled in q's type
// (load_scaled_row's arithmetic).
template <typename T>
__device__ __forceinline__ void load_scaled_col(const T* cols, float scale, float (&qr)[kDH],
                                                int lane) {
  const float sc = round_to<T>(scale);
#pragma unroll
  for (int d = 0; d < kDH; ++d) qr[d] = round_to<T>(to_float(cols[d * kSP<T> + lane]) * sc);
}

// Four 8 x 8 b16 blocks of the mma fragment layout (register i: block i,
// whose 8 row addresses lanes 8i .. 8i + 7 give), stored transposed.
__device__ __forceinline__ void stsm_x4_trans(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(wide::smem_addr(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

}  // namespace layout
}  // namespace wattn
