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
// one block of 64 threads per unit, the same three phases with thread i
// owning row i and then column i, one 34 KB buffer (K, then V, then the two
// 64 x 64 tiles, whose rows the column phase reads four entries at a time),
// block barriers between the phases. ptxas gives it 255 registers and spills
// about 870 bytes per thread, so four blocks (8 warps) fit an SM: it is the
// slow kernel of the set, far from its bound.

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

// Row stride of the wide kernels' 64 x 64 tiles: 16-byte aligned rows, so
// the products read four entries with one broadcast load (their row-wise
// writes, once per entry, meet 4-way bank conflicts).
constexpr int kWideStride = kWideN + 4;

// Output rows a thread sums at once in the wide kernels' products: four
// independent FMA chains, since few warps per SM leave a single chain's
// latency unhidden.
constexpr int kWideRows = 4;
static_assert(kWideRows == 4, "the transposed product reads rows as float4");

// out[r, t] = T(scale * sum_m tile(r, m) src[m, t]) for the unit's n rows,
// tile(r, m) as in column_product; thread t owns column t (DH = 64). Tile
// entries outside the unit's n x n block are 0, so the 16-byte reads may
// run past n.
template <typename T, bool kTranspose>
__device__ __forceinline__ void wide_column_product(const T* __restrict__ src, const float* tile,
                                                    T* __restrict__ out, int t, int n,
                                                    float scale) {
  constexpr int DH = 64;
  float col[kWideN];
#pragma unroll
  for (int m = 0; m < kWideN; ++m) col[m] = m < n ? to_float(src[m * DH + t]) : 0.f;
  for (int r = 0; r < n; r += kWideRows) {
    float acc[kWideRows];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) acc[i] = 0.f;
    if constexpr (kTranspose) {  // tile(m, r .. r + 3): one load per key row m
#pragma unroll
      for (int m = 0; m < kWideN; ++m) {
        if (m < n) {
          const float4 x = *reinterpret_cast<const float4*>(tile + m * kWideStride + r);
          acc[0] = fmaf(x.x, col[m], acc[0]);
          acc[1] = fmaf(x.y, col[m], acc[1]);
          acc[2] = fmaf(x.z, col[m], acc[2]);
          acc[3] = fmaf(x.w, col[m], acc[3]);
        }
      }
    } else {  // tile(r + i, m .. m + 3): one load per row and four keys
#pragma unroll
      for (int m = 0; m < kWideN; m += 4) {
        if (m < n) {
#pragma unroll
          for (int i = 0; i < kWideRows; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(tile + (r + i) * kWideStride + m);
            acc[i] = fmaf(x.x, col[m], acc[i]);
            acc[i] = fmaf(x.y, col[m + 1], acc[i]);
            acc[i] = fmaf(x.z, col[m + 2], acc[i]);
            acc[i] = fmaf(x.w, col[m + 3], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWideRows; ++i)
      if (r + i < n) out[(r + i) * DH + t] = from_float<T>(acc[i] * scale);
  }
}

// Units of n <= kWideN tokens, DH = 64: one block of kWideN threads per unit.
template <typename T>
__global__ void __launch_bounds__(kWideN)
window_attention_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ dout,
                                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                 const unsigned long long* __restrict__ masks,
                                 const int* __restrict__ sel, const float* __restrict__ prune_u,
                                 int n, float scale, int zero_quirk, int dual, int stack,
                                 int per_group, int groups, long long unit_offset) {
  constexpr int DH = 64;
  constexpr int kEpv = 16 / sizeof(T);
  // K, then V (n x DH each), then the two tiles (64 x kWideStride each)
  __shared__ __align__(16) float smem[2 * kWideN * kWideStride];

  const int t = threadIdx.x;
  const long long unit = blockIdx.x;
  const long long base = unit * n * DH;
  const long long row = base + static_cast<long long>(t) * DH;

  // Row phase: scores, prune, mask and softmax of row t, as the forward.
  stage_rows<T, DH, kWideN>(k + base, smem, t, n);
  __syncthreads();
  float a[kWideN];
  unsigned long long pass = 0ull;
  if (t < n) {
    float qr[DH];
    load_scaled_row<T, DH>(q + row, scale, qr);
    const auto allowed_row = [&] {
      return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * n + t];
    };
    float sum;
    pass = attention_row<kWideN, DH>(qr, smem, n, prune_u, allowed_row, zero_quirk, a, sum);
#pragma unroll
    for (int j = 0; j < kWideN; ++j) a[j] = a[j] / sum;
  } else {
#pragma unroll
    for (int j = 0; j < kWideN; ++j) a[j] = 0.f;
  }
  __syncthreads();  // K is dead in every thread

  // dA row t = dO row t . V rows (V rows are broadcasts), then dS in place.
  stage_rows<T, DH, kWideN>(v + base, smem, t, n);
  __syncthreads();
  float ds[kWideN];
#pragma unroll
  for (int j = 0; j < kWideN; ++j) ds[j] = 0.f;
  if (t < n) {
#pragma unroll
    for (int h = 0; h < DH; h += 32) {
      float dor[32];
#pragma unroll
      for (int c = 0; c < 32 / kEpv; ++c) load16(dout + row + h + c * kEpv, dor + c * kEpv);
#pragma unroll
      for (int j = 0; j < kWideN; ++j) {
        if (j < n) {
          const float4* vr = reinterpret_cast<const float4*>(smem + j * DH + h);
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
    }
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < kWideN; ++j) rowsum += ds[j] * a[j];
#pragma unroll
    for (int j = 0; j < kWideN; ++j) {
      const float g = a[j] * (ds[j] - rowsum);
      ds[j] = round_to<T>(((pass >> j) & 1ull) ? g : 0.f);
    }
  }
  __syncthreads();  // V is dead in every thread

  // T(A) and dS into their tiles (zero outside the unit's n x n block).
  float* at = smem;
  float* dst = smem + kWideN * kWideStride;
#pragma unroll
  for (int j = 0; j < kWideN; ++j) {
    at[t * kWideStride + j] = round_to<T>(a[j]);
    dst[t * kWideStride + j] = ds[j];
  }
  __syncthreads();

  wide_column_product<T, true>(dout + base, at, dv + base, t, n, 1.f);
  wide_column_product<T, true>(q + base, dst, dk + base, t, n, scale);
  wide_column_product<T, false>(k + base, dst, dq + base, t, n, scale);
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
  window_attention_bwd_wide_kernel<T><<<static_cast<unsigned>(a.units), kWideN, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<const unsigned long long*>(a.masks), a.sel, a.prune_u,
      a.tokens, a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
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
