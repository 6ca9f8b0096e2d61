// Fused adjacency-masked window attention, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_attention.py::_bwd_kernel (and computes
// the same function as its layout twins _bwd_kernel_batched, _bwd_kernel_t,
// _bwd_kernel_ts, _bwd_kernel_ts_batched, _bwd_kernel_wide,
// _bwd_kernel_wide_batched and its compact mode) on the token-major
// (U, N, DH) layout.
//
// Per unit of N tokens x DH (N = 32 with DH 32 or 64, or N <= 64 with DH
// 64), T = f32 or bf16 (q's type), with dO already in T:
//   A, pass = the forward's masked softmax, recomputed by the same code
//             (window_attention_common.cuh), so the kept entries are the same
//   dV = T(A)^T dO              f32 sums, stored as T
//   dA = dO V^T                 f32
//   dS = T(A o (dA - rowsum(dA o A)) o pass)
//   dQ = T((dS K) * scale),  dK = T((dS^T Q) * scale)
// The TPU kernel works on 128-row supertiles of 4 units whose cross-unit
// entries of A are exactly 0, so those entries add nothing to any product or
// row sum: working per unit is exact and skips 3/4 of the tile's work.
//
// Bound on an H100 SXM: bytes. A call reads q, k, v, dO and writes dq, dk,
// dv once: 7 * U * 32 * DH elements, 352 MB in bf16 at U = 12288, DH = 64
// (105 us at 3.35 TB/s), against 8.05 GFLOP (8 us on the bf16 tensor cores);
// in f32 705 MB (210 us) against 120 us of f32 CUDA-core work.
//
// Units of 32 tokens (window_attention_bwd_kernel, HWGATE): one warp per
// unit, kWarps units per block, no block barriers; each warp stages its
// unit in its own shared memory by cp.async. The row phase and the product
// phase are window_attention_bwd_unit.cuh's, which the layout kernel
// (window_attention_layout_bwd.cu) shares; this file stages the token-major
// rows and stores the strips along them.
//   Row phase, lane i owns query row i: A and its pass bits from K1's own
//   routine (attention_row of window_attention_common.cuh, keys as f32 rows),
//   so the forward's A, prune decisions included, comes out bit for bit.
//   Then dA = dO V^T and dS = T(A o (dA - rowsum(dA o A)) o pass).
//   Product phase, on two 16-row strips of the unit's outputs:
//   dV = T(A)^T dO, dK = T((dS^T Q) * scale), dQ = T((dS K) * scale).
// f32 (4 warps a block, 16 KB a warp, 3 blocks an SM): K and V staged, dO's
// row read by its lane; dA as f32 FMA chains over d (V's rows read as
// broadcasts), dS per row; T(A) and dS into swizzled 32 x 32 f32 tiles over
// V; the products in 4 x 8 register tiles (tile_product_of of
// window_attention_wide.cuh): dQ against K, then dV against dO and dK
// against Q, each staged in turn over K's rows. Every sum runs over m (or d)
// ascending by fused multiply-adds from 0, so dq, dk and dv are those of the
// one-lane-per-row design before it, bit for bit.
// bf16 (a warp a block, 26 KB a warp, 8 blocks an SM): q, k, v and dO
// staged as bf16 tiles with 16 bytes of row padding, K also as f32 rows for
// the scores. dA runs on the tensor cores (mma.sync m16n8k16, f32 sums) on
// the accumulator layout, where A meets it through a shared f32 tile (its
// sign bit set where no gradient passes); dS then stays in registers as
// dQ's A operand, and goes as a bf16 tile, with T(A), to dV and dK
// (ldmatrix.trans).
// The products, 80% of the FMAs, take 4 x 8 register tiles or the tensor
// cores instead of one 32-wide column array a lane, so nothing spills.
//
// Units of up to 64 tokens (window_attention_bwd_wide_kernel, HGATE's 58):
// one block of 4 warps per unit; q, k, v and dO staged in shared memory by
// cp.async beside the f32 score tiles of the forward (70 KB in bf16, 102 KB
// in f32). Each warp recomputes A for its 16 query rows with the forward's
// routine (window_attention_wide.cuh) and forms dA = dO V^T on the same
// accumulator layout, then dS; after a block barrier the score tiles hold
// T(A) and dS, each warp forms dQ = dS K for its rows and, after another,
// dV = T(A)^T dO and dK = dS^T Q for key rows 16w .. 16w + 15. bf16 runs
// these four products on the tensor cores (mma.sync m16n8k16, f32 sums; dS
// passes to dQ in registers, the transposed products read the tiles by
// ldmatrix.trans); f32 runs them as exact f32 products on the CUDA cores
// (4 x 8 register tiles). The scores are f32 on the CUDA cores in both, as
// the forward's.
// Bound at HGATE's batch 16 (3072 units of 58 tokens): bytes in bf16, 160 MB
// (48 us at 3.35 TB/s) against 6.6 GFLOP (7 us on the tensor cores);
// operations in f32 (99 us on the CUDA cores) against 319 MB (95 us).

#include "window_attention_common.cuh"
#include "window_attention_wide.cuh"
#include "window_attention_bwd_unit.cuh"

namespace {

using namespace wattn;
using wide::stage_unit;

// 32-token units a block, one a warp.
template <typename T> constexpr int kWarps = std::is_same<T, float>::value ? 4 : 1;
using bwd32::kTStride;
using bwd32::kXStride;

// Rows of a bf16 tile of DH columns: 16 bytes of padding.
template <int DH> constexpr int kRowStride = DH + 8;

// Shared memory of one warp, bytes. f32: K (f32 rows, DH apart), whose
// space dO and then Q take over once dQ is done; V, whose space the T(A) and
// dS tiles take over. bf16: the q, k, v, dO tiles, then K as f32 rows, whose
// space the f32 A tile and the T(A) tile take over (dS takes V's).
template <typename T, int DH>
constexpr int kWarpBytes =
    std::is_same<T, float>::value
        ? 4 * (kN * DH + (kN * DH > 2 * kN * kN ? kN * DH : 2 * kN * kN))
        : 4 * kN * kRowStride<DH> * 2 +
              (kN * DH * 4 > kN * kXStride * 4 + kN * kTStride * 2 ? kN * DH * 4
                                                                   : kN * kXStride * 4 +
                                                                         kN * kTStride * 2);
template <typename T, int DH> constexpr int kBlockBytes = kWarps<T> * kWarpBytes<T, DH>;
// Blocks an SM holds by shared memory (228 KB, 1 KB of it reserved per
// block), at most 12 warps' worth, so that a thread may take 168 registers.
template <typename T, int DH>
constexpr int kBlocksPerSm = 233472 / (kBlockBytes<T, DH> + 1024) < 12 / kWarps<T>
                                 ? 233472 / (kBlockBytes<T, DH> + 1024)
                                 : 12 / kWarps<T>;

// K2's token-major operands for the shared f32 product phase: the stores
// of window_attention_wide.cuh's register tiles along the unit's rows, dO
// and Q staged as rows by cp.async.
template <int DH>
struct UnitRowsF32 {
  const float* q;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int lane;
  float scale;
  template <typename Acc>
  __device__ __forceinline__ void store_dq(const Acc& acc, int r0) {
    wide::store_tile_of<false, DH>(dq, acc, r0, lane, kN, scale);
  }
  __device__ __forceinline__ void stage_dout(float* kf) {
    stage_unit<float, DH, DH>(dout, kf, lane);
    wide::cp_async_wait_all();
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dv(const Acc& acc, int r0) {
    wide::store_tile_of<true, DH>(dv, acc, r0, lane, kN, 1.f);
  }
  __device__ __forceinline__ void stage_q(float* kf) {
    stage_unit<float, DH, DH>(q, kf, lane);
    wide::cp_async_wait_all();
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dk(const Acc& acc, int r0) {
    wide::store_tile_of<true, DH>(dk, acc, r0, lane, kN, scale);
  }
};

// One 32-token unit in f32 (pointers at the unit's first row).
template <int DH, typename AllowedRow>
__device__ __forceinline__ void unit_bwd(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout, float* __restrict__ dq,
                                         float* __restrict__ dk, float* __restrict__ dv,
                                         unsigned char* smem, int lane, float scale,
                                         const float* __restrict__ prune_u,
                                         AllowedRow allowed_row, int zero_quirk) {
  float* kf = reinterpret_cast<float*>(smem);  // K: the keys and dQ's B; then dO, then Q
  float* vf = kf + kN * DH;                    // V, then the T(A) and dS tiles
  stage_unit<float, DH, DH>(k, kf, lane);
  stage_unit<float, DH, DH>(v, vf, lane);
  float a[kN];
  uint32_t pass;
  {
    float qr[DH];
    load_scaled_row<float, DH>(q + lane * DH, scale, qr);
    wide::cp_async_wait_all();
    __syncwarp();
    pass = bwd32::attention<DH>(qr, kf, prune_u, allowed_row, zero_quirk, a);
  }
  float ds[kN];
  bwd32::grad_row<DH>(vf, [&](int h, float (&dor)[16]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) load16(dout + lane * DH + h + c * 4, dor + c * 4);
  }, a, pass, ds);

  // V is dead in every lane: T(A) and dS into their tiles, row `lane`.
  float* at = vf;
  float* dst = vf + kN * kN;
  __syncwarp();
  bwd32::write_grad_tiles(a, ds, at, dst, lane);
  __syncwarp();
  UnitRowsF32<DH> io{q, dout, dq, dk, dv, lane, scale};
  bwd32::products_f32<DH, false>(io, at, dst, dst, kf, lane);
}

// K2's token-major operands for the shared bf16 product phase: fragments
// from the staged row tiles (rows S apart), strips stored along the unit's
// rows.
template <int DH>
struct UnitRowsBf16 {
  static constexpr int S = kRowStride<DH>;
  const __nv_bfloat16* qt;
  const __nv_bfloat16* kt;
  const __nv_bfloat16* vt;
  const __nv_bfloat16* dot;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int lane;
  template <typename Acc>
  __device__ __forceinline__ void da(int r0, Acc& acc) {
    wide::strip_abt<DH, S>(dot, vt, r0, lane, acc);
  }
  template <typename P, typename Acc>
  __device__ __forceinline__ void dq_product(const P& p, Acc& acc) {
    wide::strip_ab<S>(p, kt, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dq(const Acc& acc, int r0, float scale) {
    wide::store_strip<DH>(dq, acc, r0, lane, kN, scale);
  }
  template <typename Acc>
  __device__ __forceinline__ void dv_product(const __nv_bfloat16* at, int r0, Acc& acc) {
    wide::strip_atb<kN / 16, kTStride, S>(at, dot, r0, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dv(const Acc& acc, int r0) {
    wide::store_strip<DH>(dv, acc, r0, lane, kN, 1.f);
  }
  template <typename Acc>
  __device__ __forceinline__ void dk_product(const __nv_bfloat16* dst, int r0, Acc& acc) {
    wide::strip_atb<kN / 16, kTStride, S>(dst, qt, r0, lane, acc);
  }
  template <typename Acc>
  __device__ __forceinline__ void store_dk(const Acc& acc, int r0, float scale) {
    wide::store_strip<DH>(dk, acc, r0, lane, kN, scale);
  }
};

// One 32-token unit in bf16 (pointers at the unit's first row).
template <int DH, typename AllowedRow>
__device__ __forceinline__ void unit_bwd(const __nv_bfloat16* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v,
                                         const __nv_bfloat16* __restrict__ dout,
                                         __nv_bfloat16* __restrict__ dq,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, unsigned char* smem,
                                         int lane, float scale, const float* __restrict__ prune_u,
                                         AllowedRow allowed_row, int zero_quirk) {
  using bf16 = __nv_bfloat16;
  constexpr int S = kRowStride<DH>;
  bf16* qt = reinterpret_cast<bf16*>(smem);
  bf16* kt = qt + kN * S;
  bf16* vt = kt + kN * S;
  bf16* dot = vt + kN * S;
  float* kf = reinterpret_cast<float*>(dot + kN * S);  // K as f32 rows, DH apart
  float* ax = kf;  // then A, row r at r * kXStride, sign bit set where no gradient passes
  bf16* at = reinterpret_cast<bf16*>(ax + kN * kXStride);  // T(A), kTStride apart
  bf16* dst = vt;  // dS, kTStride apart, once V is dead
  stage_unit<bf16, DH, S>(q, qt, lane);
  stage_unit<bf16, DH, S>(k, kt, lane);
  stage_unit<bf16, DH, S>(v, vt, lane);
  stage_unit<bf16, DH, S>(dout, dot, lane);
  wide::cp_async_wait_all();
  __syncwarp();
#pragma unroll
  for (int c = lane; c < kN * DH / 8; c += 32) {
    const int r = c / (DH / 8), x = (c % (DH / 8)) * 8;
    float t[8];
    load16(kt + r * S + x, t);
    *reinterpret_cast<float4*>(kf + r * DH + x) = make_float4(t[0], t[1], t[2], t[3]);
    *reinterpret_cast<float4*>(kf + r * DH + x + 4) = make_float4(t[4], t[5], t[6], t[7]);
  }
  __syncwarp();
  float a[kN];
  uint32_t pass;
  {
    float qr[DH];
    load_scaled_row<bf16, DH>(qt + lane * S, scale, qr);
    pass = bwd32::attention<DH>(qr, kf, prune_u, allowed_row, zero_quirk, a);
  }

  // K's f32 rows are dead in every lane: A with its pass signs, and T(A).
  __syncwarp();
  bwd32::write_a_tiles(a, pass, ax, at, lane);
  UnitRowsBf16<DH> io{qt, kt, vt, dot, dq, dk, dv, lane};
  bwd32::products_bf16<DH>(io, ax, at, dst, lane, scale);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps<T> * 32, kBlocksPerSm<T, DH>)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const uint32_t* __restrict__ masks,
                            const int* __restrict__ sel,
                            const float* __restrict__ prune_u, long long units,
                            float scale, int zero_quirk, int dual, int stack,
                            int per_group, int groups, long long unit_offset) {
  extern __shared__ __align__(16) unsigned char unit_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps<T> + warp;
  if (unit >= units) return;
  const long long base = unit * kN * DH;
  const auto allowed_row = [&] {
    return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN + lane];
  };
  unit_bwd<DH>(q + base, k + base, v + base, dout + base, dq + base, dk + base, dv + base,
               unit_smem + warp * kWarpBytes<T, DH>, lane, scale, prune_u, allowed_row,
               zero_quirk);
}

// Units of n <= 64 tokens, DH = 64: one block of wide::kThreads per unit,
// warp w on query rows 16w .. 16w + 15 for A, dA, dS and dQ, then on key
// rows 16w .. 16w + 15 for dV and dK (window_attention_wide.cuh).
template <typename T>
__global__ void __launch_bounds__(wide::kThreads, wide::kMinBlocks)
window_attention_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                 const unsigned long long* __restrict__ masks,
                                 const int* __restrict__ sel, const float* __restrict__ prune_u,
                                 int n, float scale, int zero_quirk, int dual, int stack,
                                 int per_group, int groups, long long unit_offset) {
  using namespace wide;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  T* qs = reinterpret_cast<T*>(wide_smem);
  T* ks = qs + kTileElems<T>;
  T* vs = ks + kTileElems<T>;
  T* dos = vs + kTileElems<T>;
  // The f32 score tiles, then (once every warp has its scores) the T(A) and
  // dS tiles, query rows x keys.
  float* qf = reinterpret_cast<float*>(dos + kTileElems<T>);
  float* kf = qf + kTileElems<float>;
  T* at = reinterpret_cast<T*>(qf);
  T* dst = at + kTileElems<T>;

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const long long unit = blockIdx.x;
  const long long base = unit * n * kDH;
  stage_tile(q + base, qs, n, tid);
  stage_tile(k + base, ks, n, tid);
  stage_tile(v + base, vs, n, tid);
  stage_tile(dout + base, dos, n, tid);
  stage_f32(q + base, qf, n, tid, round_to<T>(scale));
  stage_f32(k + base, kf, n, tid, 1.f);
  cp_async_wait_all();
  __syncthreads();

  const bool active = r0 < n;  // warp-uniform
  float a[8][4], ds[8][4];
  if (active) {
    // A and its pass bits, recomputed as the forward computes them.
    const auto allowed_row = [&](int row) {
      return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * n + row];
    };
    const uint32_t pass = strip_attention(qf, kf, r0, lane, n, prune_u, allowed_row, zero_quirk, a);
    // dA = dO V^T on the same layout, then dS = T(A o (dA - rowsum(dA o A)) o pass).
    strip_abt(dos, vs, r0, lane, ds);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) rowsum += ds[j][2 * h + e] * a[j][2 * h + e];
      rowsum = quad_sum(rowsum);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float g = a[j][2 * h + e] * (ds[j][2 * h + e] - rowsum);
          ds[j][2 * h + e] = round_to<T>(((pass >> (4 * j + 2 * h + e)) & 1u) ? g : 0.f);
        }
    }
  }
  __syncthreads();  // the score tiles are dead in every warp

  if (active) {
    write_strip(at, a, r0, lane);
    write_strip(dst, ds, r0, lane);
    // dQ = T((dS K) * scale) for the warp's own query rows.
    if constexpr (kTensorCores<T>) {
      uint32_t p[4][4];
      to_a_operand(ds, p);
      float acc[8][4];
      strip_ab(p, ks, lane, acc);
      store_strip(dq + base, acc, r0, lane, n, scale);
    } else {
      __syncwarp();
      float acc[4][8];
      tile_product<false>(dst, ks, r0, lane, acc);
      store_tile<false>(dq + base, acc, r0, lane, n, scale);
    }
  } else {  // rows past the unit: zeros in both tiles
    for (int i = lane; i < 16 * kDH; i += 32) {
      const int idx = (r0 + i / kDH) * kStride<T> + i % kDH;
      at[idx] = from_float<T>(0.f);
      dst[idx] = from_float<T>(0.f);
    }
  }
  __syncthreads();  // both tiles complete

  // dV = T(A)^T dO and dK = T((dS^T Q) * scale) for key rows r0 .. r0 + 15.
  if (!active) return;
  if constexpr (kTensorCores<T>) {
    float acc[8][4];
    strip_atb(at, dos, r0, lane, acc);
    store_strip(dv + base, acc, r0, lane, n, 1.f);
    strip_atb(dst, qs, r0, lane, acc);
    store_strip(dk + base, acc, r0, lane, n, scale);
  } else {
    float acc[4][8];
    tile_product<true>(at, dos, r0, lane, acc);
    store_tile<true>(dv + base, acc, r0, lane, n, 1.f);
    tile_product<true>(dst, qs, r0, lane, acc);
    store_tile<true>(dk + base, acc, r0, lane, n, scale);
  }
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv;
  const void* masks; const int* sel; const float* prune_u;
  long long units; int tokens; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.units + kWarps<T> - 1) / kWarps<T>;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<T, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kBlockBytes<T, DH>);
  if (err != cudaSuccess) return err;
  window_attention_bwd_kernel<T, DH><<<static_cast<unsigned>(blocks), kWarps<T> * 32,
                                       kBlockBytes<T, DH>, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<const uint32_t*>(a.masks), a.sel, a.prune_u, a.units,
      a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const Args& a) {
  constexpr int kBytes = 4 * wide::kTileElems<T> * static_cast<int>(sizeof(T)) +
                         2 * wide::kTileElems<float> * static_cast<int>(sizeof(float));
  if (a.units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  window_attention_bwd_wide_kernel<T>
      <<<static_cast<unsigned>(a.units), wide::kThreads, kBytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), static_cast<const unsigned long long*>(a.masks), a.sel,
          a.prune_u, a.tokens, a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups,
          a.unit_offset);
  return cudaGetLastError();
}

// As the forward: 32-token units with DH 32 or 64, else up to 64 tokens, DH 64.
template <typename T>
cudaError_t launch_dh(int dh, const Args& a) {
  if (a.tokens == kN && dh == 32) return launch<T, 32>(a);
  if (a.tokens == kN && dh == 64) return launch<T, 64>(a);
  if (a.tokens >= 1 && a.tokens <= kWideN && dh == 64) return launch_wide<T>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv share it.
// `masks` as the forward's. Returns a cudaError_t (0 = launched).
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, void* dq, void* dk, void* dv,
                                    const void* masks, const void* sel, const void* prune_u,
                                    long long units, int tokens, int dh, int dtype, float scale,
                                    int zero_quirk, int dual, int stack, int per_group,
                                    int groups, long long unit_offset, void* stream) {
  if (units <= 0 || stack <= 0 || (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, masks, static_cast<const int*>(sel),
               static_cast<const float*>(prune_u), units, tokens, scale, zero_quirk, dual,
               stack, per_group, groups, unit_offset, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_dh<float>(dh, a);
  else if (dtype == 1) err = launch_dh<__nv_bfloat16>(dh, a);
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) and threads of one block of the
// 32-token kernel for head dim `dh` and dtype code `dtype`. Returns a
// cudaError_t.
extern "C" int window_attention_bwd_block(int dh, int dtype, int* smem, int* threads) {
  if ((dh != 32 && dh != 64) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = dtype == 0 ? (dh == 32 ? kBlockBytes<float, 32> : kBlockBytes<float, 64>)
                     : (dh == 32 ? kBlockBytes<__nv_bfloat16, 32> : kBlockBytes<__nv_bfloat16, 64>);
  *threads = (dtype == 0 ? kWarps<float> : kWarps<__nv_bfloat16>) * 32;
  return 0;
}
