// Masked softmax of per-unit attention scores, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/hybrid_attention.py::_softmax_bwd_kernel. Per row
// of the saved f32 scores S (U, n, n), n <= 64, with dP in TP (P's type):
//   A, pass = the forward's masked softmax, recomputed by the same code
//             (masked_softmax_common.cuh), so the kept entries are the same
//   dS = A o (dP - rowsum(dP o A)) o pass, stored in f32 (the scores' type).
// Per-unit rows give the TPU kernel's diagonal blocks; its cross-unit and
// padded entries are exactly 0 in A, hence in dS.
//
// Bound on an H100 SXM: bytes. A call reads S (4 bytes) and dP (4 or 2) and
// writes dS (4) once per entry: 151 / 126 MB at HWGATE's 12288 x 32 x 32,
// 45 / 38 us at 3.35 TB/s. One warp per row, as the forward: coalesced loads
// of the row, warp shuffles for the reductions, one coalesced store.

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

constexpr int kWarps = 8;  // rows per block

template <typename TP, int kCols>
__global__ void __launch_bounds__(kWarps * 32)
masked_softmax_bwd_kernel(const float* __restrict__ s, const TP* __restrict__ dp,
                          float* __restrict__ ds, const unsigned long long* __restrict__ masks,
                          const int* __restrict__ sel, const float* __restrict__ prune_u,
                          long long rows, int n, int zero_quirk, int dual, int stack,
                          int per_group, int groups, long long unit_offset) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const long long unit = row / n;
  const int i = static_cast<int>(row - unit * n);
  const float* sr = s + row * n;
  const TP* dpr = dp + row * n;

  float x[kCols], d[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = lane + 32 * c;
    x[c] = j < n ? __ldg(sr + j) : 0.f;
    d[c] = j < n ? wattn::to_float(dpr[j]) : 0.f;
  }
  const unsigned long long allowed =
      row_mask(masks, unit, i, n, dual, sel, stack, per_group, groups, unit_offset);
  float a[kCols];
  const unsigned pass = masked_softmax_row<kCols>(x, lane, n, allowed, prune_u, zero_quirk, a);

  float rowsum = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) rowsum += d[c] * a[c];
  rowsum = warp_sum(rowsum);
  float* dsr = ds + row * n;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < n) dsr[lane + 32 * c] = ((pass >> c) & 1u) ? a[c] * (d[c] - rowsum) : 0.f;
}

struct Args {
  const float* s; const void* dp; float* ds; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long rows; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TP, int kCols>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.rows + kWarps - 1) / kWarps;
  masked_softmax_bwd_kernel<TP, kCols><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                                         a.stream>>>(
      a.s, static_cast<const TP*>(a.dp), a.ds, a.masks, a.sel, a.prune_u, a.rows, a.n,
      a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t launch_cols(const Args& a) {
  return a.n <= 32 ? launch<TP, 1>(a) : launch<TP, 2>(a);
}

}  // namespace

// s: (units, n, n) f32 scores; dp: their probabilities' gradient in dp_dtype
// (0 = float32, 1 = bfloat16); ds: (units, n, n) f32 out; masks: (2, n)
// 64-bit row masks. Returns a cudaError_t (0 = launched).
extern "C" int masked_softmax_bwd(const void* s, const void* dp, void* ds, const void* masks,
                                  const void* sel, const void* prune_u, long long units, int n,
                                  int dp_dtype, int zero_quirk, int dual, int stack,
                                  int per_group, int groups, long long unit_offset,
                                  void* stream) {
  if (units <= 0 || n < 1 || n > 64 || stack <= 0 ||
      (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(s), dp, static_cast<float*>(ds),
               static_cast<const unsigned long long*>(masks), static_cast<const int*>(sel),
               static_cast<const float*>(prune_u), units * n, n, zero_quirk, dual, stack,
               per_group, groups, unit_offset, static_cast<cudaStream_t>(stream)};
  if (dp_dtype == 0) return static_cast<int>(launch_cols<float>(a));
  if (dp_dtype == 1) return static_cast<int>(launch_cols<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
