// The window-attention backward of one 32-token unit, a warp a unit, in the
// steps that K2 on token-major units (window_attention_bwd.cu) and K2 on
// strided views of the TPU layouts (window_attention_layout_bwd.cu) share
// (sm_90a). Each kernel stages its operands and stores its gradients in its
// own form; the arithmetic between, and the order of every sum, is this
// header's, so the two give the same bits on the same units.
//
//   Row phase, lane i owns query row i: A and its pass bits from K1's own
//   routine (attention_row of window_attention_common.cuh, keys as f32 rows
//   DH apart), so the forward's A, prune decisions included, comes out bit
//   for bit. f32 then forms dA = dO V^T (FMA chains over d ascending, V's
//   rows read as broadcasts) and dS = A o (dA - rowsum(dA o A)) o pass.
//   Product phase, on two 16-row strips of the unit's outputs:
//   dQ = T((dS K) * scale), dV = T(A)^T dO, dK = T((dS^T Q) * scale).
//   f32: 4 x 8 register tiles over swizzled 32 x 32 T(A) and dS tiles
//   (wide::tile_product_of: every sum over m ascending from 0, one fused
//   multiply-add after another), K, then dO, then Q as f32 rows in one space.
//   bf16: dA, dQ, dV and dK on mma.sync m16n8k16 (f32 sums); A meets dA on
//   the accumulator layout through a shared f32 tile (its sign bit set where
//   no gradient passes); dS stays in registers as dQ's A operand and goes as
//   a bf16 tile, with T(A), to dV and dK.
// The kernel's `io` gives the fragments that depend on its operands' form
// and stores the strips (f32: also stages dO and Q as rows).

#pragma once

#include "window_attention_common.cuh"
#include "window_attention_wide.cuh"

namespace wattn {
namespace bwd32 {

using bf16 = __nv_bfloat16;

constexpr int kTStride = kN + 8;  // bf16 32 x 32 tiles: 16 bytes of row padding
constexpr int kXStride = kN + 4;  // the f32 A tile of the bf16 path

// Row phase: the probabilities of query row `lane` (A = e / sum) and their
// pass bits, from the query row qr (scaled in q's type) and the keys as f32
// rows DH apart.
template <int DH, typename AllowedRow>
__device__ __forceinline__ uint32_t attention(const float (&qr)[DH], const float* kf,
                                              const float* __restrict__ prune_u,
                                              AllowedRow allowed_row, int zero_quirk,
                                              float (&a)[kN]) {
  float sum;
  const uint32_t pass = attention_row<kN, DH>(qr, kf, kN, prune_u, allowed_row, zero_quirk, a, sum);
#pragma unroll
  for (int j = 0; j < kN; ++j) a[j] = a[j] / sum;
  return pass;
}

// ---- f32 -------------------------------------------------------------------

// dS row `lane` in f32: dA = dO row . V rows (V's rows DH apart in `vf`, d
// ascending from 0), then dS = A o (dA - rowsum(dA o A)) o pass.
// `dout_chunk(h, x)` puts features h .. h + 15 of the lane's dO row in x.
template <int DH, typename DoutChunk>
__device__ __forceinline__ void grad_row(const float* vf, DoutChunk dout_chunk,
                                         const float (&a)[kN], uint32_t pass, float (&ds)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) ds[j] = 0.f;
#pragma unroll
  for (int h = 0; h < DH; h += 16) {  // dO's row 16 columns at a time
    float dor[16];
    dout_chunk(h, dor);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vf + j * DH + h);
      float acc = ds[j];
#pragma unroll
      for (int d4 = 0; d4 < 4; ++d4) {
        const float4 vv = vr[d4];
        acc = fmaf(dor[4 * d4], vv.x, acc);
        acc = fmaf(dor[4 * d4 + 1], vv.y, acc);
        acc = fmaf(dor[4 * d4 + 2], vv.z, acc);
        acc = fmaf(dor[4 * d4 + 3], vv.w, acc);
      }
      ds[j] = acc;
    }
  }
  float rowsum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) rowsum += ds[j] * a[j];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float g = a[j] * (ds[j] - rowsum);
    ds[j] = ((pass >> j) & 1u) ? g : 0.f;
  }
}

// Row `lane` of T(A) and of dS into their swizzled 32 x 32 tiles.
__device__ __forceinline__ void write_grad_tiles(const float (&a)[kN], const float (&ds)[kN],
                                                 float* at, float* dst, int lane) {
#pragma unroll
  for (int c = 0; c < kN; c += 4) {
    const int i = wide::Swizzled32::at(lane, c);
    *reinterpret_cast<float4*>(at + i) = make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    *reinterpret_cast<float4*>(dst + i) = make_float4(ds[c], ds[c + 1], ds[c + 2], ds[c + 3]);
  }
}

// The f32 product phase: dQ from `dq_tile` (dS, or dS^T with kDqT) and K's
// rows in `kf`, then dV = T(A)^T dO and dK = dS^T Q with dO's and then Q's
// rows staged over K's; each output as two 16-row strips of 4 x 8 register
// tiles, stored by `io` (store_dq, store_dv, store_dk: the tile of
// tile_product_of<kDqT>, <true>, <true>; stage_dout and stage_q: the rows in
// `kf`, complete in the calling lane).
template <int DH, bool kDqT, typename IO>
__device__ __forceinline__ void products_f32(IO& io, float* at, float* dst, float* dq_tile,
                                             float* kf, int lane) {
  constexpr int kHalves = DH / 32;
  float acc[4][4 * kHalves];
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    wide::tile_product_of<kDqT, kN, kHalves>(wide::Swizzled32{dq_tile}, wide::Shared<DH>{kf}, r0,
                                             lane, acc);
    io.store_dq(acc, r0);
  }
  __syncwarp();  // K is dead in every lane
  io.stage_dout(kf);
  __syncwarp();
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    wide::tile_product_of<true, kN, kHalves>(wide::Swizzled32{at}, wide::Shared<DH>{kf}, r0,
                                            lane, acc);
    io.store_dv(acc, r0);
  }
  __syncwarp();  // dO is dead in every lane
  io.stage_q(kf);
  __syncwarp();
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    wide::tile_product_of<true, kN, kHalves>(wide::Swizzled32{dst}, wide::Shared<DH>{kf}, r0,
                                            lane, acc);
    io.store_dk(acc, r0);
  }
}

// ---- bf16 ------------------------------------------------------------------

// Row `lane` of A into the f32 tile `ax` (rows kXStride apart, the sign bit
// set where no gradient passes) and of T(A) into the bf16 tile `at` (rows
// kTStride apart).
__device__ __forceinline__ void write_a_tiles(const float (&a)[kN], uint32_t pass, float* ax,
                                              bf16* at, int lane) {
#pragma unroll
  for (int c = 0; c < kN; c += 4) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = __uint_as_float(__float_as_uint(a[c + e]) | (((pass >> (c + e)) & 1u) ? 0u : 0x80000000u));
    *reinterpret_cast<float4*>(ax + lane * kXStride + c) = make_float4(x[0], x[1], x[2], x[3]);
  }
#pragma unroll
  for (int c = 0; c < kN; c += 8)
    *reinterpret_cast<uint4*>(at + lane * kTStride + c) =
        make_uint4(wide::pack_bf16(a[c], a[c + 1]), wide::pack_bf16(a[c + 2], a[c + 3]),
                   wide::pack_bf16(a[c + 4], a[c + 5]), wide::pack_bf16(a[c + 6], a[c + 7]));
}

// The bf16 product phase, once A's tiles are written: dA = dO V^T on the
// accumulator layout (both strips), dS = T(A o (dA - rowsum(dA o A)) o pass),
// dQ = T((dS K) * scale) per strip with dS in registers, dS into `dst` (rows
// kTStride apart, over V once V is dead), then dV = T(A)^T dO and
// dK = T((dS^T Q) * scale) for key rows r0 .. r0 + 15. `io`: da (dO V^T of
// a strip), dq_product (P K), dv_product (T(A)^T dO), dk_product (dS^T Q)
// and the stores store_dq, store_dv, store_dk.
template <int DH, typename IO>
__device__ __forceinline__ void products_bf16(IO& io, const float* ax, const bf16* at, bf16* dst,
                                              int lane, float scale) {
  float da[2][kN / 8][4];
  io.da(0, da[0]);
  io.da(16, da[1]);
  __syncwarp();  // A's tiles are complete; V is dead in every lane

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    float(&ds)[kN / 8][4] = da[st];
    const int r0 = 16 * st;
    // dS = T(A o (dA - rowsum(dA o A)) o pass)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* arow = ax + (r0 + g + 8 * h) * kXStride + 2 * t;
      float av[kN / 8][2];
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(arow + 8 * j);
        av[j][0] = x.x;
        av[j][1] = x.y;
#pragma unroll
        for (int e = 0; e < 2; ++e) rowsum += ds[j][2 * h + e] * fabsf(av[j][e]);
      }
      rowsum = wide::quad_sum(rowsum);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g2 = fabsf(av[j][e]) * (ds[j][2 * h + e] - rowsum);
          ds[j][2 * h + e] = round_to<bf16>(__float_as_uint(av[j][e]) >> 31 ? 0.f : g2);
        }
    }
    // dQ = T((dS K) * scale) for the strip's query rows.
    uint32_t p[kN / 16][4];
    wide::to_a_operand(ds, p);
    float acc[DH / 8][4];
    io.dq_product(p, acc);
    io.store_dq(acc, r0, scale);
    wide::write_strip<bf16, kTStride>(dst, ds, r0, lane);
  }
  __syncwarp();  // the dS tile is complete

  // dV = T(A)^T dO and dK = T((dS^T Q) * scale) for key rows r0 .. r0 + 15.
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    float acc[DH / 8][4];
    io.dv_product(at, r0, acc);
    io.store_dv(acc, r0);
    io.dk_product(dst, r0, acc);
    io.store_dk(acc, r0, scale);
  }
}

}  // namespace bwd32
}  // namespace wattn
