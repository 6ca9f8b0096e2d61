// Masked softmax of per-unit attention scores, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/hybrid_attention.py::_softmax_bwd_kernel. Per row
// of the saved scores S (U, n, n) in TS (f32 or bf16, upcast to f32 on load),
// n <= 64, with dP in TP (P's type):
//   A, pass = the forward's masked softmax, recomputed by the same code
//             (masked_softmax_common.cuh), so the kept entries are the same
//   dS = A o (dP - rowsum(dP o A)) o pass, in f32, stored in TS (the
//        scores' type; bf16 rounded to nearest even, as XLA's astype).
// Per-unit rows give the TPU kernel's diagonal blocks; its cross-unit and
// padded entries are exactly 0 in A, hence in dS.
//
// Bound on an H100 SXM: bytes. A call reads S (4 or 2 bytes) and dP (4 or 2)
// and writes dS (S's 4 or 2) once per entry: 151 / 126 / 75.5 MB at HWGATE's
// 12288 x 32 x 32 (f32 S and dP / f32 S, bf16 dP / bf16 S and dP), 45 / 38 /
// 23 us at 3.35 TB/s. Rows are laid over the lanes as the forward lays
// them (a row per 8 or 16 lanes, four columns a lane by the n-chosen map,
// 128 / n units a block), which the shared row routine fixes; the row sum
// adds one more group reduction.

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;


template <typename TS, typename TP, int kLanes, int kMap>
__global__ void __launch_bounds__(kThreads)
masked_softmax_bwd_kernel(const TS* __restrict__ s, const TP* __restrict__ dp,
                          TS* __restrict__ ds, const unsigned long long* __restrict__ masks,
                          const int* __restrict__ sel, const float* __restrict__ prune_u,
                          long long units, int n, int zero_quirk, int dual, int stack,
                          int per_group, int groups, long long unit_offset, int vec) {
  __shared__ int plane[kMinRows];
  const auto B = BlockRows<kLanes>::of(blockIdx.x, units, n);
  B.planes(plane, dual, sel, stack, per_group, groups, unit_offset);
  __syncthreads();
  for (int base = B.first(); base < B.rows(); base += B.kStep) {
    const int r = base + B.g;
    float x[kPer] = {}, d[kPer] = {};
    if (r < B.rows()) {
      load_cols<kLanes, kMap>(s + B.offset(r), B.l, n, vec, x);
      load_cols<kLanes, kMap>(dp + B.offset(r), B.l, n, vec, d);
    }
    float a[kPer];
    const unsigned pass = masked_softmax_row<kLanes, kMap>(x, B.l, n, B.allowed(masks, plane, r),
                                                           prune_u, zero_quirk, a);
    float rowsum = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) rowsum += d[c] * a[c];
    rowsum = group_sum<kLanes>(rowsum);
#pragma unroll
    for (int c = 0; c < kPer; ++c) x[c] = ((pass >> c) & 1u) ? a[c] * (d[c] - rowsum) : 0.f;
    if (r < B.rows()) store_cols<kLanes, kMap>(ds + B.offset(r), B.l, n, vec, x);
  }
}

struct Args {
  const void* s; const void* dp; void* ds; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long units; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TS, typename TP, int kLanes, int kMap>
cudaError_t launch(const Args& a) {
  const int upb = units_per_block(a.n);
  const long long blocks = (a.units + upb - 1) / upb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(a.s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.dp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.ds) % 16 == 0;
  masked_softmax_bwd_kernel<TS, TP, kLanes, kMap><<<static_cast<unsigned>(blocks), kThreads, 0,
                                                    a.stream>>>(
      static_cast<const TS*>(a.s), static_cast<const TP*>(a.dp), static_cast<TS*>(a.ds), a.masks, a.sel, a.prune_u, a.units, a.n,
      a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset, vec);
  return cudaGetLastError();
}

template <typename TS, typename TP, int kLanes>
cudaError_t launch_map(const Args& a) {
  const int map = column_map(a.n);
  return map == kQuads ? launch<TS, TP, kLanes, kQuads>(a)
         : map == kPairs ? launch<TS, TP, kLanes, kPairs>(a)
                         : launch<TS, TP, kLanes, kSingles>(a);
}

template <typename TS, typename TP>
cudaError_t launch_lanes(const Args& a) {
  return a.n <= 32 ? launch_map<TS, TP, 8>(a) : launch_map<TS, TP, 16>(a);
}

template <typename TS>
cudaError_t launch_types(const Args& a, int dp_dtype) {
  if (dp_dtype == 0) return launch_lanes<TS, float>(a);
  if (dp_dtype == 1) return launch_lanes<TS, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// s: (units, n, n) scores in s_dtype; dp: their probabilities' gradient in
// dp_dtype (each 0 = float32, 1 = bfloat16); ds: (units, n, n) out in
// s_dtype; masks: (2, n) 64-bit row masks. Returns a cudaError_t (0 =
// launched).
extern "C" int masked_softmax_bwd(const void* s, const void* dp, void* ds, const void* masks,
                                  const void* sel, const void* prune_u, long long units, int n,
                                  int s_dtype, int dp_dtype, int zero_quirk, int dual, int stack,
                                  int per_group, int groups, long long unit_offset,
                                  void* stream) {
  if (units <= 0 || n < 1 || n > 64 || stack <= 0 ||
      (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{s, dp, ds, static_cast<const unsigned long long*>(masks), static_cast<const int*>(sel),
               static_cast<const float*>(prune_u), units, n, zero_quirk, dual, stack,
               per_group, groups, unit_offset, static_cast<cudaStream_t>(stream)};
  if (s_dtype == 0) return static_cast<int>(launch_types<float>(a, dp_dtype));
  if (s_dtype == 1) return static_cast<int>(launch_types<__nv_bfloat16>(a, dp_dtype));
  return static_cast<int>(cudaErrorInvalidValue);
}
