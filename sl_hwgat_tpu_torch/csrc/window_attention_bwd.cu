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
// (105 us at 3.35 TB/s), against 8.05 GFLOP (8 us on the bf16 tensor cores,
// 120 us as f32 on the CUDA cores, which is what this kernel uses).
//
// Work split: one warp per unit, kWarps units per block, no block barriers,
// and one 8 KB buffer of shared memory per warp, used three times in turn:
//   Row phase, lane i owns query row i: K (f32) in the buffer, scores of row
//   i as broadcast reads, A and its passthrough bits; then V (f32) in the
//   buffer, dA of row i (dO row i read in 32-column halves, which keeps the
//   registers at 128), dS of row i. Then T(A) and dS go into the buffer as
//   two 32 x 32 tiles, XOR-swizzled so that the row writes hit 32 banks.
//   Column phase, lane d owns columns d and d + 32: dV = T(A)^T dO,
//   dK = dS^T Q and dQ = dS K, each with the source's columns in registers
//   (coalesced loads), the tile's entries as broadcast reads, and coalesced
//   stores.
// At 128 registers and 32 KB per block, four blocks (16 warps) fit an SM.
// ptxas spills 100-260 bytes per thread to stay at 128; left alone it takes
// 228-242 registers, which fits only two blocks per SM, and the kernel is
// slower for it.
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

namespace {

using namespace wattn;

constexpr int kWarps = 4;
constexpr int kMinBlocks = 4;  // per SM: caps the registers at 128

// Floats of shared memory per warp: K, then V, then the two tiles.
template <int DH> constexpr int kBufFloats = kN * DH > 2 * kN * kN ? kN * DH : 2 * kN * kN;

// Entry (r, c) of a swizzled 32 x 32 tile.
__device__ __forceinline__ int tile_at(int r, int c) { return r * kN + (c ^ r); }

// out[r, d] = T(scale * sum_m tile(r, m) src[m, d]) for every row r, where
// tile(r, m) is the tile's entry (r, m), or (m, r) when kTranspose: lane
// owns columns lane + 32c, src's columns are in registers.
template <typename T, int DH, bool kTranspose>
__device__ __forceinline__ void column_product(const T* __restrict__ src, const float* tile,
                                               T* __restrict__ out, int lane, float scale) {
  constexpr int kCols = DH / 32;
  float col[kN][kCols];
#pragma unroll
  for (int m = 0; m < kN; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) col[m][c] = to_float(src[m * DH + c * 32 + lane]);
  for (int r = 0; r < kN; ++r) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
    for (int m = 0; m < kN; ++m) {
      const float t = tile[kTranspose ? tile_at(m, r) : tile_at(r, m)];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(t, col[m][c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[r * DH + c * 32 + lane] = from_float<T>(acc[c] * scale);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const uint32_t* __restrict__ masks,
                            const int* __restrict__ sel,
                            const float* __restrict__ prune_u, long long units,
                            float scale, int zero_quirk, int dual, int stack,
                            int per_group, int groups, long long unit_offset) {
  constexpr int kEpv = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) float smem[kWarps][kBufFloats<DH>];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;
  const long long base = unit * kN * DH;
  const long long row = base + static_cast<long long>(lane) * DH;
  float* buf = smem[warp];

  // Scores, prune, mask and softmax of row `lane` against K, recomputed as
  // the forward computes them.
  stage_rows<T, DH, 32>(k + base, buf, lane, kN);
  float a[kN];
  uint32_t pass;
  {
    float qr[DH];
    load_scaled_row<T, DH>(q + row, scale, qr);
    __syncwarp();
    const auto allowed_row = [&] {
      return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN +
                   lane];
    };
    float sum;
    pass = attention_row<kN, DH>(qr, buf, kN, prune_u, allowed_row, zero_quirk, a, sum);
#pragma unroll
    for (int j = 0; j < kN; ++j) a[j] = a[j] / sum;
  }

  // dA row `lane` = dO row . V rows, then dS in place. K is dead in every lane.
  __syncwarp();
  stage_rows<T, DH, 32>(v + base, buf, lane, kN);
  __syncwarp();
  float ds[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) ds[j] = 0.f;
#pragma unroll
  for (int h = 0; h < DH; h += 32) {
    float dor[32];
#pragma unroll
    for (int c = 0; c < 32 / kEpv; ++c) load16(dout + row + h + c * kEpv, dor + c * kEpv);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(buf + j * DH + h);
      float acc = ds[j];
#pragma unroll
      for (int d4 = 0; d4 < 8; ++d4) {
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
    ds[j] = round_to<T>(((pass >> j) & 1u) ? g : 0.f);
  }

  // V is dead in every lane: T(A) and dS into their tiles.
  float* at = buf;
  float* dst = buf + kN * kN;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    at[tile_at(lane, j)] = round_to<T>(a[j]);
    dst[tile_at(lane, j)] = ds[j];
  }
  __syncwarp();

  column_product<T, DH, true>(dout + base, at, dv + base, lane, 1.f);
  column_product<T, DH, true>(q + base, dst, dk + base, lane, scale);
  column_product<T, DH, false>(k + base, dst, dq + base, lane, scale);
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
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  window_attention_bwd_kernel<T, DH><<<static_cast<unsigned>(blocks), kWarps * 32, 0, a.stream>>>(
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
