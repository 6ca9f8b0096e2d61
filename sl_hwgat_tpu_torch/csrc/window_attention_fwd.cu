// Fused adjacency-masked window attention, forward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_attention.py::_fwd_kernel (masking in
// _masked_attn_matrix) and computes the same function as that kernel's layout
// twins (_fwd_kernel_batched, _fwd_kernel_t, _fwd_kernel_ts,
// _fwd_kernel_ts_batched, _fwd_kernel_wide, _fwd_kernel_wide_batched) on the
// token-major (U, N, DH) layout.
//
// Per unit of N = 32 tokens x DH (32 or 64), in f32 or bf16:
//   S = (q * T(scale)) k^T     the scaled q is rounded to q's type T; f32 sums
//   prune (optional):          P0 = softmax_j(S); S[P0 > u] = 0, u read from
//                              device memory (no host sync)
//   S[!adj | (zero_quirk & S == 0)] = -1e4
//   A = softmax_j(S), rounded to v's type;  O = A V with f32 sums, stored as TO.
// The mask plane (plain adjacency or the shifted blocks' tail plane) is picked
// per unit: from `sel` (one int per supertile of `stack` units) when given,
// else from the temporal-group phase (units_per_group, groups, unit_offset).
//
// The TPU kernel stacks 4 units into a 128-row supertile and drives
// cross-unit scores to -2e4; after the f32 softmax those entries are exactly
// 0 (exp underflow), so working per unit gives the same result and skips the
// 3/4 of the score work that the stacking wastes.
//
// Bound on an H100 SXM: bytes. A call reads q, k, v and writes o once:
// 4 * U * 32 * DH elements, 201 MB in bf16 at the flagship U = 12288, DH = 64,
// i.e. 60 us at 3.35 TB/s, against 3.2 GFLOP (3 us on the bf16 tensor cores).
// The design keeps everything except q/k/v/o on chip: scores, both softmaxes
// and the masks live in registers and shared memory, and each input byte is
// read from device memory once, with 16-byte loads. The products run on the
// CUDA cores in f32 (no wgmma, no TMA yet), which a later change replaces.
//
// Work split: one warp per unit, kWarps units per block, no block-wide
// barriers. Lane i owns query row i for the scores and both softmaxes; for
// A V lane d owns output columns d (and d + 32), so the stores coalesce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 32;
constexpr int kWarps = 4;
constexpr float kNeg = -10000.0f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value a T-typed store of x would keep.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16 bytes of T at a 16-byte aligned p -> 16 / sizeof(T) floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, typename TO, int DH>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, TO* __restrict__ o,
                            const uint32_t* __restrict__ masks,
                            const int* __restrict__ sel,
                            const float* __restrict__ prune_u, long long units,
                            float scale, int zero_quirk, int dual, int stack,
                            int per_group, int groups, long long unit_offset) {
  constexpr int kEpv = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int kCols = DH / 32;           // output columns per lane
  constexpr int kPStride = kN + 1;         // padded row of the probability tile
  constexpr int kScratch = kN * DH > kN * kPStride ? kN * DH : kN * kPStride;
  // Per warp: K as f32, later overwritten by the probability tile.
  __shared__ __align__(16) float scratch[kWarps][kScratch];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;
  const long long base = unit * kN * DH;
  float* ks = scratch[warp];

  // K -> shared memory, coalesced 16-byte loads, 16-byte stores.
  for (int e = lane; e < kN * DH / kEpv; e += 32) {
    float t[kEpv];
    load16(k + base + static_cast<long long>(e) * kEpv, t);
    float4* dst = reinterpret_cast<float4*>(ks + e * kEpv);
#pragma unroll
    for (int i = 0; i < kEpv / 4; ++i)
      dst[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
  }

  // Query row `lane` into registers, scaled in q's type (q * T(scale)).
  const float sc = round_to<T>(scale);
  float qr[DH];
#pragma unroll
  for (int c = 0; c < DH / kEpv; ++c)
    load16(q + base + static_cast<long long>(lane) * DH + c * kEpv, qr + c * kEpv);
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = round_to<T>(qr[d] * sc);
  __syncwarp();

  // Scores of row `lane`; K rows are broadcast reads.
  float s[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(ks + j * DH);
    float acc = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 kk = kr[d4];
      acc = fmaf(qr[4 * d4], kk.x, acc);
      acc = fmaf(qr[4 * d4 + 1], kk.y, acc);
      acc = fmaf(qr[4 * d4 + 2], kk.z, acc);
      acc = fmaf(qr[4 * d4 + 3], kk.w, acc);
    }
    s[j] = acc;
  }

  // Train-time pruning over the raw scores of the unit.
  if (prune_u != nullptr) {
    const float u = __ldg(prune_u);
    float m = s[0];
#pragma unroll
    for (int j = 1; j < kN; ++j) m = fmaxf(m, s[j]);
    float e[kN];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      e[j] = expf(s[j] - m);
      sum += e[j];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (e[j] / sum > u) s[j] = 0.f;
  }

  // Mask plane of this unit, then multiplicative adjacency + zero quirk.
  int plane = 0;
  if (dual) {
    const long long tile = unit / stack;
    if (sel != nullptr)
      plane = sel[tile] != 0;
    else
      plane = ((tile * stack + unit_offset) / per_group) % groups == groups - 1;
  }
  const uint32_t allowed = masks[plane * kN + lane];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const bool keep = ((allowed >> j) & 1u) && (!zero_quirk || s[j] != 0.f);
    s[j] = keep ? s[j] : kNeg;
  }

  // Row softmax.
  float m = s[0];
#pragma unroll
  for (int j = 1; j < kN; ++j) m = fmaxf(m, s[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }

  // V column(s) of lane into registers (coalesced).
  float vr[kN][kCols];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      vr[j][c] = to_float(v[base + j * DH + c * 32 + lane]);

  // Probabilities, rounded to v's type, into the warp's scratch (K is dead).
  __syncwarp();
  float* ps = scratch[warp];
#pragma unroll
  for (int j = 0; j < kN; ++j) ps[lane * kPStride + j] = round_to<T>(s[j] / sum);
  __syncwarp();

  // O = A V: lane owns columns lane + 32c; probability rows are broadcasts.
  for (int i = 0; i < kN; ++i) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float p = ps[i * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(p, vr[j][c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[base + i * DH + c * 32 + lane] = from_float<TO>(acc[c]);
  }
}

struct Args {
  const void* q; const void* k; const void* v; void* o;
  const uint32_t* masks; const int* sel; const float* prune_u;
  long long units; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T, typename TO, int DH>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  window_attention_fwd_kernel<T, TO, DH><<<static_cast<unsigned>(blocks), kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<TO*>(a.o), a.masks, a.sel, a.prune_u, a.units, a.scale, a.zero_quirk,
      a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_dh(int dh, const Args& a) {
  if (dh == 32) return launch<T, TO, 32>(a);
  if (dh == 64) return launch<T, TO, 64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* masks, const void* sel, const void* prune_u,
                                    long long units, int dh, int in_dtype, int out_dtype,
                                    float scale, int zero_quirk, int dual, int stack,
                                    int per_group, int groups, long long unit_offset,
                                    void* stream) {
  if (units <= 0 || stack <= 0 || (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<const uint32_t*>(masks), static_cast<const int*>(sel),
               static_cast<const float*>(prune_u), units, scale, zero_quirk, dual, stack,
               per_group, groups, unit_offset, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) err = launch_dh<float, float>(dh, a);
  else if (in_dtype == 0 && out_dtype == 1) err = launch_dh<float, __nv_bfloat16>(dh, a);
  else if (in_dtype == 1 && out_dtype == 0) err = launch_dh<__nv_bfloat16, float>(dh, a);
  else if (in_dtype == 1 && out_dtype == 1) err = launch_dh<__nv_bfloat16, __nv_bfloat16>(dh, a);
  return static_cast<int>(err);
}
