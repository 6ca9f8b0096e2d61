// Fused adjacency-masked window attention, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_attention.py::_bwd_kernel (and computes
// the same function as its layout twins _bwd_kernel_batched, _bwd_kernel_t,
// _bwd_kernel_ts, _bwd_kernel_ts_batched, _bwd_kernel_wide,
// _bwd_kernel_wide_batched and its compact mode) on the token-major
// (U, N, DH) layout.
//
// Per unit of N = 32 tokens x DH (32 or 64), T = f32 or bf16 (q's type), with
// dO already in T:
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

#include "window_attention_common.cuh"

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
  stage_rows<T, DH>(k + base, buf, lane);
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
    pass = attention_row<DH>(qr, buf, prune_u, allowed_row, zero_quirk, a, sum);
#pragma unroll
    for (int j = 0; j < kN; ++j) a[j] = a[j] / sum;
  }

  // dA row `lane` = dO row . V rows, then dS in place. K is dead in every lane.
  __syncwarp();
  stage_rows<T, DH>(v + base, buf, lane);
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

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv;
  const uint32_t* masks; const int* sel; const float* prune_u;
  long long units; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  window_attention_bwd_kernel<T, DH><<<static_cast<unsigned>(blocks), kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.masks, a.sel, a.prune_u, a.units, a.scale, a.zero_quirk,
      a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const Args& a) {
  if (dh == 32) return launch<T, 32>(a);
  if (dh == 64) return launch<T, 64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv share it.
// Returns a cudaError_t (0 = launched).
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, void* dq, void* dk, void* dv,
                                    const void* masks, const void* sel, const void* prune_u,
                                    long long units, int dh, int dtype, float scale,
                                    int zero_quirk, int dual, int stack, int per_group,
                                    int groups, long long unit_offset, void* stream) {
  if (units <= 0 || stack <= 0 || (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, static_cast<const uint32_t*>(masks),
               static_cast<const int*>(sel), static_cast<const float*>(prune_u), units, scale,
               zero_quirk, dual, stack, per_group, groups, unit_offset,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_dh<float>(dh, a);
  else if (dtype == 1) err = launch_dh<__nv_bfloat16>(dh, a);
  return static_cast<int>(err);
}
