// Fused adjacency-masked window attention, backward, read and written in the
// TPU layouts of the kernel bench, for Hopper (sm_90a).
//
// Replaces the layout twins of sl_hwgat_tpu/ops/pallas_attention.py::_bwd_kernel
// as the bench drives them: _bwd_kernel_t (:386), _bwd_kernel_ts (:704),
// _bwd_kernel_ts_batched (:466), _bwd_kernel_wide (:526) and
// _bwd_kernel_wide_batched (:598), behind bench_kernel.py's
// pallas_tbwd_bf16, pallas_tsbwd_bf16 and pallas_widebwd_bf16. It computes
// K2's function (window_attention_bwd.cu) on 32-token units with DH 64 where
// q, k, v, dO, dq, dk and dv lie: each operand is a columns view of
// window_attention_layout.cuh (a feature's 32 tokens contiguous: the
// transposed units and supertiles, the widened planes), and none moves to
// token-major first.
//
// Bound on an H100 SXM: bytes, as K2's. A call reads q, k, v, dO and writes
// dq, dk, dv once: 7 * U * 32 * 64 elements, 352 MB in bf16 at the bench's
// 12288 units (105 us at 3.35 TB/s), 705 MB in f32 (210 us). Before this
// kernel the bench's gradient entries moved every operand to token-major and
// back with the relayout kernel around K1 and K2: six transposes of 50 MB.
//
// Design: K2's at 32 tokens (a warp per unit, 2 a block, the warp's own
// shared memory, no block-wide barrier, 32-bit unit offsets). The row phase
// and the product phase are window_attention_bwd_unit.cuh's, the routines K2
// runs, in K2's order, so dq, dk and dv equal K2's output on the plainly
// permuted inputs bit for bit. What differs is how the operands arrive and
// leave:
//   bf16: q, k, v and dO staged by cp.async as DH rows of 32 tokens, padded
//     by 16 bytes; k also as f32 rows for attention_row (key_cols_to_rows);
//     lane i takes query row i straight from q's columns; every product's
//     fragments by ldmatrix on the transposed tiles, .trans where K2 reads
//     rows without it and plain where K2 uses .trans, which gives the
//     registers K2 loads and so its mma.sync sums; each 16-row strip of dq,
//     dk and dv out through a 2 KB tile of the warp (stmatrix .trans, a
//     feature's two 16-byte chunks swapped where d / 4 is odd, so neither
//     the stores nor the reads meet a bank conflict) by 16-byte stores along
//     tokens. 28 KB a warp, 4 blocks (8 warps) an SM.
//   f32: k and v, then dO, then q staged as columns and turned into f32
//     rows in place (each lane reads its row's 64 values, then writes them:
//     no bank conflicts either way); the query row and the dO row read by
//     their lane straight from the columns (one token of every feature,
//     coalesced across the warp); dS^T written beside dS, so that dQ, like
//     dV and dK, runs on transposed register tiles, whose 4 consecutive
//     tokens a lane stores as one 16-byte chunk (the sums over m are the
//     same: tile_product_of sums each entry in m order either way). 22 KB a
//     warp; 255 registers hold it to 8 warps an SM. It runs 1.07 card ms
//     at the bench's units, 2.6x K2-32 f32 (NVIDIA H100 80GB HBM3, 700 W):
//     its global column stores cost about 0.4 of it (sent to shared memory
//     instead, the kernel takes 0.69), for a reason not found yet; the
//     bench's gradient entries are bf16.

#include "window_attention_bwd_unit.cuh"
#include "window_attention_layout.cuh"

namespace {

using namespace wattn;
using namespace wattn::layout;
using bwd32::kTStride;
using bwd32::kXStride;

constexpr int kWarps = 2;       // 32-token units a block, one a warp
constexpr int kAllCols = 0x7f;  // forms: bit 0 q, 1 k, 2 v, 3 dO, 4 dq, 5 dk, 6 dv; 1 = columns

// One warp's shared memory, bytes. bf16: q, k, v, dO as column tiles, then K
// as f32 rows (then A's f32 tile and T(A)); dS and the strips' store tile
// take v's tile once V is dead. f32: k's columns (then K's rows, dO's, Q's),
// v's (then V's rows, then T(A) and dS), and dS^T.
constexpr int kWarpBf16 = 4 * kColBytes<bf16> + kN * kDH * 4;
constexpr int kWarpF32 = 2 * kColBytes<float> + kN * kN * 4;
constexpr int kStoreTile = kDH * 16;  // bf16: a strip of 16 tokens, DH features
static_assert(kN * kXStride * 4 + kN * kTStride * 2 <= kN * kDH * 4, "A's tiles over K's rows");
static_assert((kN * kTStride + kStoreTile) * 2 <= kColBytes<bf16>, "dS and a strip over V");
static_assert(2 * kN * kN * 4 <= kColBytes<float>, "T(A) and dS over V");

template <typename T> constexpr int kWarpBytes = std::is_same<T, float>::value ? kWarpF32 : kWarpBf16;
template <typename T> constexpr int kBlockBytes = kWarps * kWarpBytes<T>;
// Blocks an SM by shared memory (228 KB, 1 KB of it reserved per block):
// bf16's launch bound; f32 is unbounded (bounded to its 5 blocks, ptxas held
// it to 168 registers and spilled).
template <typename T> constexpr int kBlocksPerSm = 233472 / (kBlockBytes<T> + 1024);
template <typename T> constexpr int kMinBlocks = std::is_same<T, float>::value ? 1 : kBlocksPerSm<T>;

struct Views {
  View q, k, v, dout, dq, dk, dv;
};

// ---- f32 ---------------------------------------------------------------------

// Staged f32 columns -> f32 rows DH apart, in place (the rows take the first
// kN * kDH floats of the columns' space): lane i reads token i of every
// feature in the order of the 4-feature chunks it then writes (starting at
// chunk i mod DH / 4), all before the first write. A read step's 32 words
// fall in 32 distinct banks (rows 16 bytes longer than the tokens), and every
// 8 lanes write 8 distinct 16-byte bank groups.
__device__ __forceinline__ void cols_to_rows_in_place(float* p, int lane) {
  constexpr int kQuads = kDH / 4;
  float w[kQuads][4];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int d = 4 * ((i + lane) % kQuads);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[i][e] = p[(d + e) * kSP<float> + lane];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int d = 4 * ((i + lane) % kQuads);
    *reinterpret_cast<float4*>(p + lane * kDH + d) = make_float4(w[i][0], w[i][1], w[i][2], w[i][3]);
  }
}

// A register tile of tile_product_of<true> (entry [ii][c]: token
// r0 + 4 (lane / 8) + ii, feature 32 (c / 4) + 4 (lane % 8) + c % 4), times
// `scale`, out to a columns view: a feature's 4 tokens as one 16-byte chunk.
template <int kC>
__device__ __forceinline__ void store_cols(float* __restrict__ out, long long ld,
                                           const float (&acc)[4][kC], int r0, int lane,
                                           float scale) {
  const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int d = 32 * (c / 4) + 4 * cg + c % 4;
    *reinterpret_cast<float4*>(out + d * ld + r0 + 4 * rg) =
        make_float4(acc[0][c] * scale, acc[1][c] * scale, acc[2][c] * scale, acc[3][c] * scale);
  }
}

// The columns views for the shared f32 product phase: strips stored along
// tokens, dO and Q staged as columns and turned into rows.
struct ColsF32 {
  const float* q;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const Views* w;
  int lane;
  float scale;
  template <typename Acc>
  __device__ __forceinline__ void store_dq(const Acc& acc, int r0) {
    store_cols(dq, w->dq.ld, acc, r0, lane, scale);
  }
  __device__ __forceinline__ void stage_rows(const float* src, long long ld, float* kf) {
    stage_cols(src, ld, kf, lane);
    wide::cp_async_wait_all();
    __syncwarp();
    cols_to_rows_in_place(kf, lane);
  }
  __device__ __forceinline__ void stage_dout(float* kf) { stage_rows(dout, w->dout.ld, kf); }
  template <typename Acc>
  __device__ __forceinline__ void store_dv(const Acc& acc, int r0) {
    store_cols(dv, w->dv.ld, acc, r0, lane, 1.f);
  }
  __device__ __forceinline__ void stage_q(float* kf) { stage_rows(q, w->q.ld, kf); }
  template <typename Acc>
  __device__ __forceinline__ void store_dk(const Acc& acc, int r0) {
    store_cols(dk, w->dk.ld, acc, r0, lane, scale);
  }
};

template <typename AllowedRow>
__device__ __forceinline__ void unit_bwd(const float* q, const float* k, const float* v,
                                         const float* dout, float* dq, float* dk, float* dv,
                                         const Views& w, unsigned char* smem, int lane,
                                         float scale, const float* __restrict__ prune_u,
                                         AllowedRow allowed_row, int zero_quirk) {
  float* ks = reinterpret_cast<float*>(smem);  // k's columns, then K's rows; then dO's, Q's
  float* vs = ks + kColBytes<float> / 4;       // v's columns, then V's rows; then T(A), dS
  float* dst_t = vs + kColBytes<float> / 4;    // dS^T
  stage_cols(k, w.k.ld, ks, lane);
  stage_cols(v, w.v.ld, vs, lane);
  wide::cp_async_wait_all();
  __syncwarp();
  cols_to_rows_in_place(ks, lane);
  cols_to_rows_in_place(vs, lane);
  __syncwarp();
  float a[kN];
  uint32_t pass;
  {
    float qr[kDH];  // load_scaled_row's arithmetic, from the columns
    const float sc = round_to<float>(scale);
    const float* qc = q + lane;
    const int ld = static_cast<int>(w.q.ld);  // DH * ld < 2^31: the C entry's check
#pragma unroll
    for (int d = 0; d < kDH; ++d) qr[d] = round_to<float>(qc[d * ld] * sc);
    pass = bwd32::attention<kDH>(qr, ks, prune_u, allowed_row, zero_quirk, a);
  }
  float ds[kN];
  const float* doc = dout + lane;
  const int ldo = static_cast<int>(w.dout.ld);
  bwd32::grad_row<kDH>(vs, [&](int h, float (&dor)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) dor[i] = doc[(h + i) * ldo];
  }, a, pass, ds);

  // V is dead in every lane: T(A), dS and dS^T into their tiles.
  float* at = vs;
  float* dst = vs + kN * kN;
  __syncwarp();
  bwd32::write_grad_tiles(a, ds, at, dst, lane);
#pragma unroll
  for (int j = 0; j < kN; ++j) dst_t[wide::Swizzled32::at(j, lane)] = ds[j];
  __syncwarp();
  ColsF32 io{q, dout, dq, dk, dv, &w, lane, scale};
  bwd32::products_f32<kDH, true>(io, at, dst, dst_t, ks, lane);
}

// ---- bf16 --------------------------------------------------------------------

// A 16-row strip on the accumulator layout (tokens r0 .. r0 + 15 x DH
// features), times `scale` and rounded to bf16, out to a columns view
// through the warp's tile `stage` (feature d's 16 tokens as two 16-byte
// chunks, swapped where d / 4 is odd): stmatrix .trans (four 8 x 8 blocks a
// store: lanes 8i .. 8i + 7 give the feature rows of block i), then 16-byte
// stores along tokens, two a feature.
__device__ __forceinline__ void store_strip_cols(const float (&acc)[kDH / 8][4], bf16* stage,
                                                 bf16* __restrict__ out, long long ld, int r0,
                                                 int lane, float scale) {
  const int blk = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < kDH / 8; j += 2) {
    const int d = 8 * (j + (blk >> 1)) + r;
    stsm_x4_trans(stage + d * 16 + (((blk & 1) ^ ((d >> 2) & 1)) << 3),
                  wide::pack_bf16(acc[j][0] * scale, acc[j][1] * scale),
                  wide::pack_bf16(acc[j][2] * scale, acc[j][3] * scale),
                  wide::pack_bf16(acc[j + 1][0] * scale, acc[j + 1][1] * scale),
                  wide::pack_bf16(acc[j + 1][2] * scale, acc[j + 1][3] * scale));
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kDH * 2 / 32; ++i) {
    const int c = lane + 32 * i, d = c >> 1, h = c & 1;
    *reinterpret_cast<uint4*>(out + d * ld + r0 + 8 * h) =
        *reinterpret_cast<const uint4*>(stage + d * 16 + ((h ^ ((d >> 2) & 1)) << 3));
  }
  __syncwarp();  // the tile is free again
}

// The columns views for the shared bf16 product phase: fragments from the
// transposed tiles, strips stored along tokens.
struct ColsBf16 {
  static constexpr int S = kSP<bf16>;
  const bf16* qt;
  const bf16* kt;
  const bf16* vt;
  const bf16* dot;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const Views* w;
  bf16* stage;
  int lane;
  template <typename Acc>
  __device__ __forceinline__ void da(int r0, Acc& acc) {
    wide::strip_abt_t<kDH, S>(dot, vt, r0, lane, acc);
  }
  template <typename P, typename Acc>
  __device__ __forceinline__ void dq_product(const P& p, Acc& acc) {
    wide::strip_ab_t<S>(p, kt, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dq(const Acc& acc, int r0, float scale) {
    store_strip_cols(acc, stage, dq, w->dq.ld, r0, lane, scale);
  }
  template <typename Acc>
  __device__ __forceinline__ void dv_product(const bf16* at, int r0, Acc& acc) {
    wide::strip_atb_t<kN / 16, kTStride, S>(at, dot, r0, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dv(const Acc& acc, int r0) {
    store_strip_cols(acc, stage, dv, w->dv.ld, r0, lane, 1.f);
  }
  template <typename Acc>
  __device__ __forceinline__ void dk_product(const bf16* dst, int r0, Acc& acc) {
    wide::strip_atb_t<kN / 16, kTStride, S>(dst, qt, r0, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dk(const Acc& acc, int r0, float scale) {
    store_strip_cols(acc, stage, dk, w->dk.ld, r0, lane, scale);
  }
};

template <typename AllowedRow>
__device__ __forceinline__ void unit_bwd(const bf16* q, const bf16* k, const bf16* v,
                                         const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                                         const Views& w, unsigned char* smem, int lane,
                                         float scale, const float* __restrict__ prune_u,
                                         AllowedRow allowed_row, int zero_quirk) {
  constexpr int kTile = kDH * kSP<bf16>;
  bf16* qt = reinterpret_cast<bf16*>(smem);
  bf16* kt = qt + kTile;
  bf16* vt = kt + kTile;
  bf16* dot = vt + kTile;
  float* kf = reinterpret_cast<float*>(dot + kTile);  // K as f32 rows, DH apart
  float* ax = kf;  // then A, row r at r * kXStride, sign bit set where no gradient passes
  bf16* at = reinterpret_cast<bf16*>(ax + kN * kXStride);  // T(A), kTStride apart
  bf16* dst = vt;  // dS, kTStride apart, once V is dead
  bf16* stage = vt + kN * kTStride;  // and the strips on their way out
  stage_cols(q, w.q.ld, qt, lane);
  stage_cols(k, w.k.ld, kt, lane);
  stage_cols(v, w.v.ld, vt, lane);
  stage_cols(dout, w.dout.ld, dot, lane);
  wide::cp_async_wait_all();
  __syncwarp();
  key_cols_to_rows(kt, kf, lane);
  __syncwarp();
  float a[kN];
  uint32_t pass;
  {
    float qr[kDH];
    load_scaled_col(qt, scale, qr, lane);
    pass = bwd32::attention<kDH>(qr, kf, prune_u, allowed_row, zero_quirk, a);
  }

  // K's f32 rows are dead in every lane: A with its pass signs, and T(A).
  __syncwarp();
  bwd32::write_a_tiles(a, pass, ax, at, lane);
  ColsBf16 io{qt, kt, vt, dot, dq, dk, dv, &w, stage, lane};
  bwd32::products_bf16<kDH>(io, ax, at, dst, lane, scale);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<T>)
window_attention_layout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ dout,
                                   T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                   const Views views, const uint32_t* __restrict__ masks,
                                   const int* __restrict__ sel, const float* __restrict__ prune_u,
                                   long long units, float scale, int zero_quirk, int dual,
                                   int stack, int per_group, int groups, long long unit_offset) {
  extern __shared__ __align__(16) unsigned char layout_bwd_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;
  const auto allowed_row = [&] {
    return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN + lane];
  };
  unit_bwd(q + unit_base(views.q, unit), k + unit_base(views.k, unit),
           v + unit_base(views.v, unit), dout + unit_base(views.dout, unit),
           dq + unit_base(views.dq, unit), dk + unit_base(views.dk, unit),
           dv + unit_base(views.dv, unit), views, layout_bwd_smem + warp * kWarpBytes<T>, lane,
           scale, prune_u, allowed_row, zero_quirk);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv; Views views;
  const void* masks; const int* sel; const float* prune_u;
  long long units; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  const auto kernel = window_attention_layout_bwd_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockBytes<T>);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, kBlockBytes<T>, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.views, static_cast<const uint32_t*>(a.masks), a.sel, a.prune_u,
      a.units, a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

// One block's dynamic shared memory for (dtype, forms), or -1 where there
// is no instantiation.
int block_bytes(int dtype, int forms) {
  if (forms != kAllCols) return -1;
  if (dtype == 0) return kBlockBytes<float>;
  if (dtype == 1) return kBlockBytes<bf16>;
  return -1;
}

}  // namespace

// q, k, v, dout (dO), dq, dk, dv: device pointers; views: host array of
// 7 x (sa, sb, ss, ld, nb, ns), in elements, in that order; dtype codes
// 0 = float32, 1 = bfloat16 (every operand); forms: bit i set where operand
// i is token-contiguous (only 0x7f, every one, has an instantiation);
// masks: (2, 32) 32-bit row bitmasks; a unit's feature stride ld below
// 2^31 / DH. Returns a cudaError_t (0 = launched).
extern "C" int window_attention_layout_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           const void* views, const void* masks, const void* sel,
                                           const void* prune_u, long long units, int dh,
                                           int dtype, int forms, float scale, int zero_quirk,
                                           int dual, int stack, int per_group, int groups,
                                           long long unit_offset, void* stream) {
  if (units <= 0 || units > 0x7fffffffLL || stack <= 0 || dh != kDH ||
      block_bytes(dtype, forms) < 0 || (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* w = static_cast<const long long*>(views);
  View vs[7];
  for (int i = 0; i < 7; ++i) {
    const long long* x = w + 6 * i;
    if (x[4] <= 0 || x[5] <= 0 || x[3] < 0 || x[3] * kDH >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    vs[i] = View{x[0], x[1], x[2], x[3], static_cast<int>(x[4]), static_cast<int>(x[5])};
  }
  const Args a{q, k, v, dout, dq, dk, dv, Views{vs[0], vs[1], vs[2], vs[3], vs[4], vs[5], vs[6]},
               masks, static_cast<const int*>(sel), static_cast<const float*>(prune_u), units,
               scale, zero_quirk, dual, stack, per_group, groups, unit_offset,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? launch<float>(a) : launch<bf16>(a));
}

// The dynamic shared memory (bytes) and threads of one block for dtype code
// `dtype` and `forms`. Returns a cudaError_t.
extern "C" int window_attention_layout_bwd_block(int dtype, int forms, int* smem, int* threads) {
  const int bytes = block_bytes(dtype, forms);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  *smem = bytes;
  *threads = kWarps * 32;
  return 0;
}
