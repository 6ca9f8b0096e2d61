// Shared by the window-attention forward and backward kernels for units of
// up to 64 tokens with head dim 64 (HGATE's 58), sm_90a.
//
// A unit runs in one block of kWarps = 4 warps. Its tensors are staged in
// shared memory as 64 x 64 tiles, rows n .. 63 zero-filled (nothing past the
// unit is read), each row padded by 16 bytes so that the fragment loads meet
// no bank conflicts: the scaled q and k as f32 tiles for the scores, v (and
// q, k, dO in the backward) in q's type T by 16-byte cp.async for the other
// products. Warp w owns the 16 query rows 16w .. 16w + 15.
//
// Scores and softmax live on the m16n8 accumulator layout of mma.sync: lane
// (g = lane / 4, t = lane % 4) holds rows r0 + g (h = 0) and r0 + g + 8
// (h = 1), keys 8j + 2t + e (j = 0 .. 7, e = 0, 1), in s[j][2h + e]. A row
// lies across the 4 lanes of a quad, so its max and sums are two shuffles.
// strip_attention (scores, prune, mask, softmax) is called by both kernels
// in the same order, so the forward's A and its pass bits come out bit for
// bit in the backward: a prune decision at the `u` boundary cannot flip
// between the two passes.
//
// The scores are exact f32 products summed in f32 on the CUDA cores, one
// fused multiply-add after another over the head dim, in both types: the
// order in which an f32 GEMM accumulates, so S keeps the plain version's
// values. Where every row of a warp keeps at most 8 keys (HGATE's skeleton
// keeps 3-8 of 58), only the kept scores are computed, and the softmax runs
// on them alone (strip_attention). Tensor-core sums are not IEEE sums: a
// score one ulp off moves A by one ulp, which can round T(A) the other way,
// and at A >= 0.5 that moves dV = T(A)^T dO by ulp(A) |dO|, past the
// backward's bar (on the card, with tensor-core scores, it did). The other
// products feed no rounding that sensitive: in bf16 they run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 sums), fragments by ldmatrix
// (.trans for the operands read across rows), and the forward feeds its
// rounded probabilities straight from the accumulators back as the A
// operand of A V. In f32 they are exact f32 products on the CUDA cores in
// 4 x 8 register tiles (lane: row group rg = lane / 8, column group
// cg = lane % 8) read from shared memory with 16-byte loads.

#pragma once

#include "window_attention_common.cuh"

namespace wattn {
namespace wide {

constexpr int kRows = 64;  // a unit's rows, padded
constexpr int kDH = 64;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;  // per SM: caps the registers at 128
constexpr float kNegInf = -__builtin_huge_valf();

// Row stride, in elements, of a shared 64 x 64 tile: 16 bytes of padding.
template <typename T> constexpr int kStride = kDH + 16 / static_cast<int>(sizeof(T));
template <typename T> constexpr int kTileElems = kRows * kStride<T>;
template <typename T> constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;

// ---- data movement -------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The 32 rows of DH elements of a 32-token unit (device memory, rows DH
// apart) into a shared tile of rows S elements apart, by cp.async: 16-byte
// chunks, one lane after another (the 32-token kernels, a warp a unit).
template <typename T, int DH, int S>
__device__ __forceinline__ void stage_unit(const T* __restrict__ src, T* dst, int lane) {
  constexpr int kEpc = 16 / sizeof(T), kChunks = DH / kEpc;
#pragma unroll
  for (int c = lane; c < kN * kChunks; c += 32)
    cp_async16(dst + c / kChunks * S + c % kChunks * kEpc, src + c * kEpc);
}

// The same from rows ld elements apart (a strided view of the unit). A
// separate overload: folding the token-major case into this one cost K2-32
// in f32 164 bytes of spills at its 168 registers.
template <typename T, int DH, int S>
__device__ __forceinline__ void stage_unit(const T* __restrict__ src, T* dst, int lane,
                                           long long ld) {
  constexpr int kEpc = 16 / sizeof(T), kChunks = DH / kEpc;
#pragma unroll
  for (int c = lane; c < kN * kChunks; c += 32) {
    const int r = c / kChunks, x = c % kChunks * kEpc;
    cp_async16(dst + r * S + x, src + r * ld + x);
  }
}

// The unit's n rows of src (n x kDH, token-major) into the padded tile dst;
// rows n .. 63 become zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, T* dst, int n, int tid) {
  constexpr int kEpc = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = kDH / kEpc;   // chunks per row
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * kEpc;
    T* d = dst + r * kStride<T> + x;
    if (r < n) cp_async16(d, src + r * kDH + x);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The unit's n rows of src times sc, each rounded to T (the value a T-typed
// multiply stores; sc = 1 keeps them), as f32 into the padded tile dst; rows
// n .. 63 become zeros.
template <typename T>
__device__ __forceinline__ void stage_f32(const T* __restrict__ src, float* dst, int n, int tid,
                                          float sc) {
  constexpr int kEpc = 16 / sizeof(T);
  constexpr int kChunks = kDH / kEpc;
  constexpr int kPer = kRows * kChunks / kThreads;  // chunks per thread
  float v[kPer][kEpc];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {  // every load in flight before the first store
    const int c = tid + i * kThreads, r = c / kChunks, x = (c % kChunks) * kEpc;
    if (r < n) load16(src + r * kDH + x, v[i]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = tid + i * kThreads, r = c / kChunks, x = (c % kChunks) * kEpc;
#pragma unroll
    for (int e = 0; e < kEpc; e += 4)
      *reinterpret_cast<float4*>(dst + r * kStride<float> + x + e) =
          r < n ? make_float4(round_to<T>(v[i][e] * sc), round_to<T>(v[i][e + 1] * sc),
                              round_to<T>(v[i][e + 2] * sc), round_to<T>(v[i][e + 3] * sc))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// Rows r0 .. r0 + 15 of the accumulator layout (x[j][2h + e] = row
// r0 + g + 8h, column 8j + 2t + e) into a shared tile of rows S elements
// apart, in T.
template <typename T, int S = kStride<T>, int kNT>
__device__ __forceinline__ void write_strip(T* tile, const float (&x)[kNT][4], int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      store2(tile + (r0 + g + 8 * h) * S + 8 * j + 2 * t, x[j][2 * h], x[j][2 * h + 1]);
}

// The same rows, times `scale` and rounded to TO, into the unit's rows
// (DH apart) in device memory; rows >= n do not exist.
template <int DH = kDH, typename TO, int kNT>
__device__ __forceinline__ void store_strip(TO* __restrict__ out, const float (&x)[kNT][4], int r0,
                                            int lane, int n, float scale) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < n)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        store2(out + row * DH + 8 * j + 2 * t, x[j][2 * h] * scale, x[j][2 * h + 1] * scale);
  }
}

// ---- bf16: tensor-core products ------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kNT>
__device__ __forceinline__ void zero(float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// acc = X[r0 .. r0 + 15] Y^T on the accumulator layout (tile j: Y's rows
// 8j .. 8j + 7) over kDepth columns; rows S elements apart.
template <int kDepth = kDH, int S = kStride<__nv_bfloat16>, int kNT>
__device__ __forceinline__ void strip_abt(const __nv_bfloat16* xs, const __nv_bfloat16* ys,
                                          int r0, int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, xs + (r0 + (lane & 15)) * S + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {  // Y rows 16jp .. 16jp + 15: tiles 2jp, 2jp + 1
      uint32_t b[4];
      ldsm_x4(b, ys + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * S + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// The accumulator layout of rows r0 .. r0 + 15 over 16 kKS columns, rounded
// to bf16, as the A operands of the kKS k-steps of a product over those
// columns (the register reuse of FlashAttention-2).
template <int kNT, int kKS>
__device__ __forceinline__ void to_a_operand(const float (&x)[kNT][4], uint32_t (&p)[kKS][4]) {
  static_assert(kNT == 2 * kKS, "two accumulator tiles per k-step");
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    p[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    p[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    p[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc = P Y: P (16 x 16 kKS) as A operands, Y a tile of 16 kKS rows, S
// elements apart, read across rows.
template <int S = kStride<__nv_bfloat16>, int kKS, int kNT>
__device__ __forceinline__ void strip_ab(const uint32_t (&p)[kKS][4], const __nv_bfloat16* ys,
                                         int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {  // output columns 16jp .. 16jp + 15
      uint32_t b[4];
      ldsm_x4_trans(b, ys + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S + 16 * jp +
                           (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], p[kk], b[2], b[3]);
    }
}

// acc = X[:, r0 .. r0 + 15]^T Y: the transposed product over the 16 kKS
// rows of two tiles (dV = A^T dO, dK = dS^T Q), for output rows r0 .. r0 +
// 15; X's rows SX elements apart, Y's SY.
template <int kKS = kRows / 16, int SX = kStride<__nv_bfloat16>, int SY = SX, int kNT>
__device__ __forceinline__ void strip_atb(const __nv_bfloat16* xs, const __nv_bfloat16* ys,
                                          int r0, int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, xs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * SX + r0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, ys + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * SY + 16 * jp +
                           (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// ---- f32: CUDA-core products ---------------------------------------------

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// strip_abt in f32: each lane sums its 32 entries of the accumulator layout,
// each one fused multiply-add after another over d = 0 .. 63 from 0, as an
// f32 GEMM sums.
__device__ __forceinline__ void strip_abt(const float* xs, const float* ys, int r0, int lane,
                                          float (&acc)[8][4]) {
  constexpr int S = kStride<float>;
  const int g = lane >> 2, t = lane & 3;
  const float* x0 = xs + (r0 + g) * S;
  const float* x1 = x0 + 8 * S;
  const float* y = ys + 2 * t * S;
  zero(acc);
#pragma unroll 1
  for (int d = 0; d < kDH; d += 4) {
    const float4 a0 = lds4(x0 + d), a1 = lds4(x1 + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = lds4(y + (8 * j + e) * S + d);
        float c0 = acc[j][e], c1 = acc[j][2 + e];
        c0 = fmaf(a0.x, b.x, c0); c1 = fmaf(a1.x, b.x, c1);
        c0 = fmaf(a0.y, b.y, c0); c1 = fmaf(a1.y, b.y, c1);
        c0 = fmaf(a0.z, b.z, c0); c1 = fmaf(a1.z, b.z, c1);
        c0 = fmaf(a0.w, b.w, c0); c1 = fmaf(a1.w, b.w, c1);
        acc[j][e] = c0;
        acc[j][2 + e] = c1;
      }
  }
}

// x . y over the head dim, one fused multiply-add after another from 0.
__device__ __forceinline__ float dot_row(const float* x, const float* y) {
  float c = 0.f;
#pragma unroll
  for (int d = 0; d < kDH; d += 4) {
    const float4 a = lds4(x + d), b = lds4(y + d);
    c = fmaf(a.x, b.x, c); c = fmaf(a.y, b.y, c); c = fmaf(a.z, b.z, c); c = fmaf(a.w, b.w, c);
  }
  return c;
}

// Row of entry ii of a lane's 4 x 8 register tile in a 16-row strip: rows
// rg + 4ii when the A operand is read along its rows (four rows a load,
// banks apart), 4rg + ii when read across them (one 16-byte load).
template <bool kTransA>
__device__ __forceinline__ int tile_row(int lane, int ii) {
  return kTransA ? 4 * (lane >> 3) + ii : (lane >> 3) + 4 * ii;
}

// f32 rows of a shared tile, read 4 floats at a time (c a multiple of 4):
// rows S floats apart (Shared), or a 32 x 32 tile whose 16-byte chunk c / 4
// of row r sits at chunk (c / 4) ^ (r % 8) (Swizzled32: a lane's row writes
// and both of tile_product's reads meet no bank conflicts).
template <int S>
struct Shared {
  const float* p;
  __device__ __forceinline__ float4 ld4(int r, int c) const { return lds4(p + r * S + c); }
};
struct Swizzled32 {
  float* p;
  __device__ __forceinline__ static int at(int r, int c) {
    return r * 32 + (((c >> 2) ^ r) & 7) * 4 + (c & 3);
  }
  __device__ __forceinline__ float4 ld4(int r, int c) const { return lds4(p + at(r, c)); }
};

// acc = A B for rows r0 .. r0 + 15 of A (kTransA: of A^T, i.e. A's columns)
// over the kK rows of B, in 4 x 4 kHalves register tiles: entry [ii][c] is
// row r0 + tile_row(ii), column 32 (c / 4) + 4cg + c % 4. Each entry is
// summed one fused multiply-add after another over k = 0 .. kK - 1 from 0.
template <bool kTransA, int kK, int kHalves, typename TA, typename TB>
__device__ __forceinline__ void tile_product_of(const TA& as, const TB& bs, int r0, int lane,
                                                float (&acc)[4][4 * kHalves]) {
  const int cg = lane & 7;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < 4 * kHalves; ++c) acc[ii][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kK; k += 4) {
    float a[4][4];  // a[ii][kk] = A(row ii, k + kk)
    if (kTransA) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 x = as.ld4(k + kk, r0 + tile_row<true>(lane, 0));
        a[0][kk] = x.x; a[1][kk] = x.y; a[2][kk] = x.z; a[3][kk] = x.w;
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 x = as.ld4(r0 + tile_row<false>(lane, ii), k);
        a[ii][0] = x.x; a[ii][1] = x.y; a[ii][2] = x.z; a[ii][3] = x.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[kHalves];
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) b[hh] = bs.ld4(k + kk, 32 * hh + 4 * cg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float x = a[ii][kk];
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {
          float* y = acc[ii] + 4 * hh;
          y[0] = fmaf(x, b[hh].x, y[0]); y[1] = fmaf(x, b[hh].y, y[1]);
          y[2] = fmaf(x, b[hh].z, y[2]); y[3] = fmaf(x, b[hh].w, y[3]);
        }
      }
    }
  }
}

// acc = A B for rows r0 .. r0 + 15 of A (kTransA: of A^T, i.e. A's columns)
// over the 64 rows of the tile B, in 4 x 8 register tiles: entry [ii][c] is
// row r0 + tile_row(ii), column 4cg + c (c < 4) or 32 + 4cg + c - 4.
template <bool kTransA>
__device__ __forceinline__ void tile_product(const float* as, const float* bs, int r0, int lane,
                                             float (&acc)[4][8]) {
  constexpr int S = kStride<float>;
  const int cg = lane & 7;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[ii][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < kRows; k += 4) {
    float a[4][4];  // a[ii][kk] = A(row ii, k + kk)
    if (kTransA) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 x = lds4(as + (k + kk) * S + r0 + tile_row<true>(lane, 0));
        a[0][kk] = x.x; a[1][kk] = x.y; a[2][kk] = x.z; a[3][kk] = x.w;
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float4 x = lds4(as + (r0 + tile_row<false>(lane, ii)) * S + k);
        a[ii][0] = x.x; a[ii][1] = x.y; a[ii][2] = x.z; a[ii][3] = x.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = lds4(bs + (k + kk) * S + 4 * cg);
      const float4 b1 = lds4(bs + (k + kk) * S + 32 + 4 * cg);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float x = a[ii][kk];
        acc[ii][0] = fmaf(x, b0.x, acc[ii][0]); acc[ii][1] = fmaf(x, b0.y, acc[ii][1]);
        acc[ii][2] = fmaf(x, b0.z, acc[ii][2]); acc[ii][3] = fmaf(x, b0.w, acc[ii][3]);
        acc[ii][4] = fmaf(x, b1.x, acc[ii][4]); acc[ii][5] = fmaf(x, b1.y, acc[ii][5]);
        acc[ii][6] = fmaf(x, b1.z, acc[ii][6]); acc[ii][7] = fmaf(x, b1.w, acc[ii][7]);
      }
    }
  }
}

// A register tile of tile_product<kTransA>, times `scale` and rounded to TO,
// into the unit's rows in device memory; rows >= n do not exist.
template <bool kTransA, typename TO>
__device__ __forceinline__ void store_tile(TO* __restrict__ out, const float (&acc)[4][8], int r0,
                                           int lane, int n, float scale) {
  const int cg = lane & 7;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + tile_row<kTransA>(lane, ii);
    if (row < n) {
      const float* x = acc[ii];
      store4(out + row * kDH + 4 * cg, x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
      store4(out + row * kDH + 32 + 4 * cg, x[4] * scale, x[5] * scale, x[6] * scale,
             x[7] * scale);
    }
  }
}

// store_tile for a register tile of tile_product_of, rows DH apart. The
// wide kernels keep tile_product and store_tile, the same arithmetic in
// their own form: routed through the generic pair, ptxas split some of the
// wide backward's 16-byte stores into 4-byte ones (its SASS) and K2 at 58
// tokens ran slower; the 32-token backward runs slower with store_tile's
// form.
template <bool kTransA, int DH, typename TO, int kC>
__device__ __forceinline__ void store_tile_of(TO* __restrict__ out, const float (&acc)[4][kC],
                                              int r0, int lane, int n, float scale) {
  const int cg = lane & 7;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + tile_row<kTransA>(lane, ii);
    if (row < n) {
      const float* x = acc[ii];
#pragma unroll
      for (int hh = 0; hh < kC / 4; ++hh)
        store4(out + row * DH + 32 * hh + 4 * cg, x[4 * hh] * scale, x[4 * hh + 1] * scale,
               x[4 * hh + 2] * scale, x[4 * hh + 3] * scale);
    }
  }
}

// ---- the shared score, prune, mask and softmax routine ---------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows of at most 4 * kSparseRounds kept keys take the compacted path of
// strip_attention: lane t of a row's quad takes its kept keys of rank t,
// t + 4, ...
constexpr int kSparseRounds = 2;

// The attention matrix A of query rows r0 .. r0 + 15 (one warp, all lanes)
// of a unit of n tokens, from the f32 tiles qs (q * T(scale), rounded to T:
// stage_f32) and ks:
//   S = qs ks^T  (exact f32 products, f32 sums in the plain version's order);
//   prune: P0 = softmax(S), S[P0 > u] = 0;
//   S[!allowed | (zero_quirk & S == 0)] = kNeg;  A = softmax(S), f32,
// into s on the accumulator layout. Keys >= n take no part in either softmax
// and get A = 0; rows >= n get A = 0 (their masks are not read).
// `allowed_row(row)` gives a row's 64-bit adjacency bits. Returns the pass
// bits (bit 4j + 2h + e of s[j][2h + e]): set where the masked score still
// equals the raw one, i.e. where the gradient flows.
//
// Without pruning, where every row of the warp keeps at most
// 4 * kSparseRounds keys and its largest kept score lies more than 104
// above kNeg (so that exp underflows to exactly 0 at every masked entry),
// only the kept entries are computed: their scores, exponentials and
// quotients, in the row's quad, then passed to their places through the
// warp's own rows of qs (each probability stored with its sign bit set
// where no gradient passes). Masked entries get A = 0 and no pass bit, as
// on the dense path unless a raw score equals kNeg exactly. Either way the
// choice depends on the inputs alone, so the forward and the backward take
// the same path.
template <typename AllowedRow>
__device__ __forceinline__ uint32_t strip_attention(float* qs, const float* ks, int r0, int lane,
                                                    int n, const float* __restrict__ prune_u,
                                                    AllowedRow allowed_row, int zero_quirk,
                                                    float (&s)[8][4]) {
  constexpr int S = kStride<float>;
  const int g = lane >> 2, t = lane & 3;
  const unsigned long long valid = n < 64 ? (1ull << n) - 1 : ~0ull;
  unsigned long long allowed[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    allowed[h] = row < n ? allowed_row(row) & valid : 0ull;
  }
  uint32_t pass = 0;

  constexpr int kMaxKeys = 4 * kSparseRounds;
  if (prune_u == nullptr && __all_sync(0xffffffffu, __popcll(allowed[0]) <= kMaxKeys &&
                                                        __popcll(allowed[1]) <= kMaxKeys)) {
    int key[2][kSparseRounds];
    float e[2][kSparseRounds], m[2];
    uint32_t quirk = 0;  // bit kSparseRounds * h + r: masked by the zero quirk
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned long long todo = allowed[h];
      for (int i = 0; i < t; ++i) todo &= todo - 1;
#pragma unroll
      for (int r = 0; r < kSparseRounds; ++r) {
        key[h][r] = todo ? __ffsll(todo) - 1 : -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) todo &= todo - 1;
      }
    }
    // The kept scores (independent chains), masked by the zero quirk.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
#pragma unroll
      for (int r = 0; r < kSparseRounds; ++r) {
        const int kk = key[h][r];
        const float raw = kk >= 0 ? dot_row(qs + (r0 + g + 8 * h) * S, ks + kk * S) : 0.f;
        const bool masked = zero_quirk && raw == 0.f;
        if (masked) quirk |= 1u << (kSparseRounds * h + r);
        e[h][r] = masked ? kNeg : raw;
        if (kk >= 0) m[h] = fmaxf(m[h], e[h][r]);
      }
      m[h] = quad_max(m[h]);
    }
    const bool vanish = (r0 + g >= n || m[0] > kNeg + 104.f) &&
                        (r0 + g + 8 >= n || m[1] > kNeg + 104.f);
    if (__all_sync(0xffffffffu, vanish)) {
      __syncwarp();  // every lane is done with the q rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kSparseRounds; ++r) {
          e[h][r] = key[h][r] >= 0 ? expf(e[h][r] - m[h]) : 0.f;
          sum += e[h][r];
          if ((quirk >> (kSparseRounds * h + r)) & 1u) e[h][r] = -0.f;  // exp gave 0: no pass
        }
        sum = quad_sum(sum);
        float* out = qs + (r0 + g + 8 * h) * S;
#pragma unroll
        for (int r = 0; r < kSparseRounds; ++r)
          if (key[h][r] >= 0) out[key[h][r]] = e[h][r] / sum;
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 x = *reinterpret_cast<const float2*>(qs + (r0 + g + 8 * h) * S + 8 * j +
                                                            2 * t);
          const float xe[2] = {x.x, x.y};
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const bool kept = (allowed[h] >> (8 * j + 2 * t + e2)) & 1ull;
            s[j][2 * h + e2] = kept ? fabsf(xe[e2]) : 0.f;
            if (kept && !(__float_as_uint(xe[e2]) >> 31)) pass |= 1u << (4 * j + 2 * h + e2);
          }
        }
      return pass;
    }
  }

  // The dense path: every score of the unit's keys.
  strip_abt(qs, ks, r0, lane, s);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    // Train-time pruning over the row's raw scores.
    uint32_t pruned = 0;  // bit 2j + e
    if (prune_u != nullptr) {
      const float u = __ldg(prune_u);
      float m = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * t + e < n) m = fmaxf(m, s[j][2 * h + e]);
      m = quad_max(m);
      float p0[8][2], total = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p0[j][e] = 8 * j + 2 * t + e < n ? expf(s[j][2 * h + e] - m) : 0.f;
          total += p0[j][e];
        }
      total = quad_sum(total);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * t + e < n && p0[j][e] / total > u) pruned |= 1u << (2 * j + e);
    }
    // Multiplicative adjacency + zero quirk, on the pruned scores.
    float m = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e;
        if (key < n) {
          const float raw = s[j][2 * h + e];
          const float sp = ((pruned >> (2 * j + e)) & 1u) ? 0.f : raw;
          const bool keep = ((allowed[h] >> key) & 1ull) && (!zero_quirk || sp != 0.f);
          const float sm = keep ? sp : kNeg;
          if (sm == raw) pass |= 1u << (4 * j + 2 * h + e);
          s[j][2 * h + e] = sm;
          m = fmaxf(m, sm);
        }
      }
    // Row softmax.
    m = quad_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = 8 * j + 2 * t + e < n ? expf(s[j][2 * h + e] - m) : 0.f;
        s[j][2 * h + e] = x;
        sum += x;
      }
    sum = quad_sum(sum);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[j][2 * h + e] = row < n ? s[j][2 * h + e] / sum : 0.f;
    if (row >= n) pass &= ~(0x33333333u << (2 * h));
  }
  return pass;
}

// ---- 32-token units, a warp a unit: the forward's shared steps ------------
// (K1 in window_attention_fwd.cu on token-major units, and
// window_attention_layout.cu on strided views of the TPU layouts)

constexpr int kATStride = kN + 8;  // the bf16 T(A) tile: rows padded by 16 bytes
// Rows of a staged q tile, and of a bf16 v tile: padded by 16 bytes, so
// that a lane's own row reads meet no bank conflicts (bf16 v: ldmatrix).
template <typename T, int DH> constexpr int kUnitPad = DH + 16 / static_cast<int>(sizeof(T));

// The unit's K rows as f32 rows DH apart, from bf16 by 16-byte loads,
// every one in flight before the first conversion; chunk(lane, i) gives
// the device address of the unit's 16-byte chunk lane + 32 i.
template <int DH, typename Chunk>
__device__ __forceinline__ void stage_keys_of(Chunk chunk, float* dst, int lane) {
  constexpr int kPer = kN * DH / 8 / 32;  // 16-byte chunks a lane
  uint4 x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) x[i] = __ldg(chunk(lane, i));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float t[8];
    load16(reinterpret_cast<const __nv_bfloat16*>(&x[i]), t);
    float4* d = reinterpret_cast<float4*>(dst + (lane + 32 * i) * 8);
    d[0] = make_float4(t[0], t[1], t[2], t[3]);
    d[1] = make_float4(t[4], t[5], t[6], t[7]);
  }
}

// The unit's K rows (DH apart in device memory, or ld apart) as f32 rows
// DH apart: by cp.async in f32, by stage_keys_of in bf16.
template <int DH>
__device__ __forceinline__ void stage_keys(const float* __restrict__ src, float* dst, int lane) {
  stage_unit<float, DH, DH>(src, dst, lane);
}
template <int DH>
__device__ __forceinline__ void stage_keys(const float* __restrict__ src, float* dst, int lane,
                                           long long ld) {
  stage_unit<float, DH, DH>(src, dst, lane, ld);
}
template <int DH>
__device__ __forceinline__ void stage_keys(const __nv_bfloat16* __restrict__ src, float* dst,
                                           int lane) {
  stage_keys_of<DH>([=](int l, int i) { return reinterpret_cast<const uint4*>(src) + l + 32 * i; },
                    dst, lane);
}
template <int DH>
__device__ __forceinline__ void stage_keys(const __nv_bfloat16* __restrict__ src, float* dst,
                                           int lane, long long ld) {
  constexpr int kChunks = DH / 8;  // a row's 16-byte chunks
  stage_keys_of<DH>([=](int l, int i) {
    const int c = l + 32 * i;
    return reinterpret_cast<const uint4*>(src + c / kChunks * ld + c % kChunks * 8);
  }, dst, lane);
}

// acc = P V with V given as V^T (DH rows of the 32 tokens, S elements
// apart): the B fragments by ldmatrix (strip_ab reads them from V's rows by
// ldmatrix.trans; the registers, and so the sums, are the same).
template <int S, int kKS, int kNT>
__device__ __forceinline__ void strip_ab_t(const uint32_t (&p)[kKS][4], const __nv_bfloat16* yt,
                                           int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {  // output columns 16jp .. 16jp + 15
      uint32_t b[4];
      ldsm_x4(b, yt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * S + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], p[kk], b[2], b[3]);
    }
}

// strip_abt with X and Y given as X^T and Y^T (DH rows of the 32 tokens, S
// elements apart): both fragments by ldmatrix.trans, the registers that
// ldmatrix gives on X's and Y's rows, so the sums are strip_abt's.
template <int kDepth, int S, int kNT>
__device__ __forceinline__ void strip_abt_t(const __nv_bfloat16* xt, const __nv_bfloat16* yt,
                                            int r0, int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kDepth / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, xt + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * S + r0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, yt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S + 16 * jp +
                           (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// strip_atb with Y given as Y^T (its columns' rows SY elements apart): the B
// fragments by ldmatrix, the registers ldmatrix.trans gives on Y's rows.
template <int kKS, int SX, int SY, int kNT>
__device__ __forceinline__ void strip_atb_t(const __nv_bfloat16* xs, const __nv_bfloat16* yt,
                                            int r0, int lane, float (&acc)[kNT][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    uint32_t a[4];
    ldsm_x4_trans(a, xs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * SX + r0 +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, yt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * SY + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// A V for a unit in bf16, on the tensor cores: T(A) (row `lane` in e / sum)
// into the padded tile `at`, the A operand by ldmatrix, then the unit's two
// 16-row strips with f32 sums; V's B fragments from V's rows S apart
// (ldmatrix.trans) or, with kVT, from V^T's rows S apart (ldmatrix). Ends
// once every lane is done with the T(A) tile and V.
template <int DH, int S, bool kVT = false>
__device__ __forceinline__ void attend_strips(const float (&e)[kN], float sum, __nv_bfloat16* at,
                                              const __nv_bfloat16* vt, int lane,
                                              float (&acc)[2][DH / 8][4]) {
#pragma unroll
  for (int c = 0; c < kN; c += 8)
    *reinterpret_cast<uint4*>(at + lane * kATStride + c) =
        make_uint4(pack_bf16(e[c] / sum, e[c + 1] / sum), pack_bf16(e[c + 2] / sum, e[c + 3] / sum),
                   pack_bf16(e[c + 4] / sum, e[c + 5] / sum), pack_bf16(e[c + 6] / sum, e[c + 7] / sum));
  __syncwarp();
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    uint32_t p[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      ldsm_x4(p[kk], at + (16 * st + (lane & 15)) * kATStride + 16 * kk + (lane >> 4) * 8);
    if constexpr (kVT) strip_ab_t<S>(p, vt, lane, acc[st]);
    else strip_ab<S>(p, vt, lane, acc[st]);
  }
  __syncwarp();
}

// O of the two strips through the warp's shared memory `os` (rows padded
// by 16 bytes: from the accumulator layout, 4- or 8-byte stores, bf16 read
// 4% slower), out to the unit's rows, ld apart, in 16-byte chunks (ld an
// int DH for token-major units, so that the offsets stay 32-bit).
template <int DH, typename TO, typename Ld>
__device__ __forceinline__ void store_unit_rows(const float (&acc)[2][DH / 8][4], TO* os,
                                                TO* __restrict__ out, Ld ld, int lane) {
  constexpr int kEpc = 16 / sizeof(TO), kOS = DH + kEpc;
#pragma unroll
  for (int st = 0; st < 2; ++st) write_strip<TO, kOS>(os, acc[st], 16 * st, lane);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < kN * DH / kEpc; c += 32) {
    const int r = c / (DH / kEpc), x = c % (DH / kEpc) * kEpc;
    *reinterpret_cast<uint4*>(out + r * ld + x) = *reinterpret_cast<const uint4*>(os + r * kOS + x);
  }
}

}  // namespace wide
}  // namespace wattn
