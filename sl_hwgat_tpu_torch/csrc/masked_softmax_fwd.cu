// Masked softmax of per-unit attention scores, forward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/hybrid_attention.py::_softmax_fwd_kernel (the
// masking of pallas_attention.py::_masked_attn_matrix) in the hybrid window
// attention: two batched GEMMs (torch.bmm) around this pass.
//
// Per row of the f32 scores S (U, n, n), n <= 64 (HWGATE 32, HGATE 58):
//   prune (optional):  P0 = softmax_j(S); S[P0 > u] = 0, u read from device
//                      memory (no host sync)
//   S[!adj | (zero_quirk & S == 0)] = -1e4
//   P = softmax_j(S) in f32, stored as TP (v's type: f32 or bf16).
// The mask plane (plain adjacency or the shifted blocks' tail plane) is picked
// per unit: from `sel` (one int per supertile of `stack` units) when given,
// else from the temporal-group phase (units_per_group, groups, unit_offset).
//
// The TPU kernel works on (T, S*Np, S*Np) supertiles whose cross-unit and
// padded entries are -2e4: after the f32 softmax those are exactly 0, so the
// per-unit (U, n, n) scores give the same P and skip the stacking's wasted
// entries (3/4 of HWGATE's tile, 1/2 plus the padding of HGATE's).
//
// Bound on an H100 SXM: bytes. A call reads S (4 bytes) and writes P (4 or
// 2 bytes) once per entry: 100.7 / 75.5 MB at HWGATE's 12288 x 32 x 32,
// 30 / 23 us at 3.35 TB/s; a few dozen operations per entry are far below
// the card's rate. The design reads each score once with coalesced loads
// (a warp reads a whole row), keeps the row in registers through both
// softmaxes (warp shuffles for the max and sum), and writes P once.

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

constexpr int kWarps = 8;  // rows per block

template <typename TP, int kCols>
__global__ void __launch_bounds__(kWarps * 32)
masked_softmax_fwd_kernel(const float* __restrict__ s, TP* __restrict__ p,
                          const unsigned long long* __restrict__ masks,
                          const int* __restrict__ sel, const float* __restrict__ prune_u,
                          long long rows, int n, int zero_quirk, int dual, int stack,
                          int per_group, int groups, long long unit_offset) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const long long unit = row / n;
  const int i = static_cast<int>(row - unit * n);
  const float* sr = s + row * n;

  float x[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) x[c] = lane + 32 * c < n ? __ldg(sr + lane + 32 * c) : 0.f;
  const unsigned long long allowed =
      row_mask(masks, unit, i, n, dual, sel, stack, per_group, groups, unit_offset);
  float a[kCols];
  masked_softmax_row<kCols>(x, lane, n, allowed, prune_u, zero_quirk, a);
  TP* pr = p + row * n;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < n) pr[lane + 32 * c] = wattn::from_float<TP>(a[c]);
}

struct Args {
  const float* s; void* p; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long rows; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TP, int kCols>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.rows + kWarps - 1) / kWarps;
  masked_softmax_fwd_kernel<TP, kCols><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                                         a.stream>>>(
      a.s, static_cast<TP*>(a.p), a.masks, a.sel, a.prune_u, a.rows, a.n, a.zero_quirk, a.dual,
      a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t launch_cols(const Args& a) {
  return a.n <= 32 ? launch<TP, 1>(a) : launch<TP, 2>(a);
}

}  // namespace

// s: (units, n, n) f32 scores; p: the same shape in p_dtype (0 = float32,
// 1 = bfloat16); masks: (2, n) 64-bit row masks. Returns a cudaError_t
// (0 = launched).
extern "C" int masked_softmax_fwd(const void* s, void* p, const void* masks, const void* sel,
                                  const void* prune_u, long long units, int n, int p_dtype,
                                  int zero_quirk, int dual, int stack, int per_group, int groups,
                                  long long unit_offset, void* stream) {
  if (units <= 0 || n < 1 || n > 64 || stack <= 0 ||
      (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(s), p, static_cast<const unsigned long long*>(masks),
               static_cast<const int*>(sel), static_cast<const float*>(prune_u), units * n, n,
               zero_quirk, dual, stack, per_group, groups, unit_offset,
               static_cast<cudaStream_t>(stream)};
  if (p_dtype == 0) return static_cast<int>(launch_cols<float>(a));
  if (p_dtype == 1) return static_cast<int>(launch_cols<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
