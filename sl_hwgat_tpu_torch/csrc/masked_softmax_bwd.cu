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
// 23 us at 3.35 TB/s; 62 MB with bf16 S and dP at HGATE's 3072 x 58 x 58,
// 19 us. Rows are laid over the lanes as the forward lays them (a row per 8
// or 16 lanes, four columns a lane by the n-chosen map), which the shared
// row routine fixes; the row sum adds one more group reduction.
//
// Two designs run the row routine; dS is the earlier design's bit for bit
// in both. Every score and dP type but f32 and f32 runs the forward's
// (masked_softmax_fwd.cu): staged_spans, a span of S and of dP (about 24 KB
// with dS: 128 rows at 32 tokens, 64 at 58 with bf16 S and dP) brought by
// two bulk copies on one mbarrier, dS written into an output stage and
// stored back by one bulk copy. f32 scores with f32 dP keep the direct
// design (a block of 128 / n whole units, each lane's columns read and
// written in device memory, 16 bytes at a time, 8 in HGATE's 58-float
// rows): staged, HWGATE's took 2.8-4.5% longer in turns with it (0.0567-
// 0.0581 against 0.0552-0.0555 ms; with twice the stage bytes, three input
// stages or one output stage too), where it moves 151 MB at 2.7 TB/s
// already. At HGATE's shape the direct design's bf16 dS, 4-byte stores a
// lane into 116-byte rows, ran slower than with f32 dP (0.0626 against
// 0.0562 ms) and than torch.softmax's backward (0.048); staged it takes
// 0.0429 ms in turns with the direct design's 0.0622, and 0.0399 against
// 0.0499 at HWGATE; f32 scores with bf16 dP 10-11% less time (bench/
// ablate.py softmax, NVIDIA H100 80GB HBM3, 700.00 W).

#include <type_traits>

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

// f32 scores and dP: the direct design, each lane's rows read and written
// in device memory.
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

// Every other score and dP type: spans staged in shared memory by bulk
// copies.
template <typename TS, typename TP, int kLanes, int kMap, int kN>
__global__ void __launch_bounds__(kThreads, kLanes == 16 ? kMinBlocks : 1)
masked_softmax_bwd_staged(const TS* __restrict__ s, const TP* __restrict__ dp,
                          TS* __restrict__ ds, const unsigned long long* __restrict__ masks,
                          const int* __restrict__ sel, const float* __restrict__ prune_u,
                          long long units, int n_arg, int zero_quirk, int dual, int stack,
                          int per_group, int groups, long long unit_offset, Layout L, int vec) {
  const int n = kN > 0 ? kN : n_arg;  // the main paths' unit sizes as constants
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kInStages];
  __shared__ int plane[kMaxSpanUnits];
  __shared__ unsigned long long staged_masks[2 * 64];
  stage_masks(staged_masks, masks, n);
  const auto R = SpanRows<kLanes>::here();
  staged_spans(
      s, dp, ds, units, n, L, smem, full,
      [&](long long u0, int count) {
        R.planes(plane, u0, count, dual, sel, stack, per_group, groups, unit_offset);
      },
      [&](const TS* ss, const TP* dps, TS* dss, int rows, int first) {
        // whole: every row of each pass exists and the rows are aligned
        auto rows_of = [&](auto whole) {
          constexpr bool kWhole = decltype(whole)::value;
          for (int base = R.first(); base < rows; base += R.kStep) {
            const int r = base + R.g;
            float x[kPer] = {}, d[kPer] = {};
            if (kWhole || r < rows) {
              load_cols<kLanes, kMap, false>(ss + r * n, R.l, n, kWhole || vec, x);
              load_cols<kLanes, kMap, false>(dps + r * n, R.l, n, kWhole || vec, d);
            }
            float a[kPer];
            const unsigned long long allowed =
                R.allowed(staged_masks, plane, r, kWhole ? r + 1 : rows, first, n);
            const unsigned pass =
                masked_softmax_row<kLanes, kMap>(x, R.l, n, allowed, prune_u, zero_quirk, a);
            float rowsum = 0.f;
#pragma unroll
            for (int c = 0; c < kPer; ++c) rowsum += d[c] * a[c];
            rowsum = group_sum<kLanes>(rowsum);
#pragma unroll
            for (int c = 0; c < kPer; ++c)
              x[c] = ((pass >> c) & 1u) ? a[c] * (d[c] - rowsum) : 0.f;
            if (kWhole || r < rows)
              store_cols<kLanes, kMap, false>(dss + r * n, R.l, n, kWhole || vec, x);
          }
        };
        if (vec && rows % R.kStep == 0) rows_of(std::true_type{});
        else rows_of(std::false_type{});
      });
}

struct Args {
  const void* s; const void* dp; void* ds; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long units; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TS, typename TP, int kLanes, int kMap, int kN>
cudaError_t launch_staged(const Args& a) {
  static Grid grid;
  const Layout L = Layout::of(a.n, kLanes, sizeof(TS), sizeof(TP), sizeof(TS));
  unsigned blocks = 0;
  const cudaError_t err = grid.size(masked_softmax_bwd_staged<TS, TP, kLanes, kMap, kN>,
                                    a.units * a.n, L, blocks);
  if (err != cudaSuccess) return err;
  const int vec = reinterpret_cast<uintptr_t>(a.s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.dp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.ds) % 16 == 0;
  masked_softmax_bwd_staged<TS, TP, kLanes, kMap, kN><<<blocks, kThreads, L.bytes(), a.stream>>>(
      static_cast<const TS*>(a.s), static_cast<const TP*>(a.dp), static_cast<TS*>(a.ds),
      a.masks, a.sel, a.prune_u, a.units, a.n, a.zero_quirk, a.dual, a.stack, a.per_group,
      a.groups, a.unit_offset, L, vec);
  return cudaGetLastError();
}

template <typename TS, typename TP, int kLanes, int kMap>
cudaError_t launch_direct(const Args& a) {
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

template <typename TS, typename TP, int kLanes, int kMap, int kN = 0>
cudaError_t launch(const Args& a) {
  if constexpr (std::is_same<TS, float>::value && std::is_same<TP, float>::value)
    return launch_direct<TS, TP, kLanes, kMap>(a);
  else return launch_staged<TS, TP, kLanes, kMap, kN>(a);
}

template <typename TS, typename TP, int kLanes>
cudaError_t launch_map(const Args& a) {
  const int map = column_map(a.n);
  return map == kQuads ? launch<TS, TP, kLanes, kQuads>(a)
         : map == kPairs ? launch<TS, TP, kLanes, kPairs>(a)
                         : launch<TS, TP, kLanes, kSingles>(a);
}

// HWGATE's 32 and HGATE's 58 tokens compiled as constants; other n as an
// argument.
template <typename TS, typename TP>
cudaError_t launch_lanes(const Args& a) {
  if (a.n == 32) return launch<TS, TP, 8, kQuads, 32>(a);
  if (a.n == 58) return launch<TS, TP, 16, kPairs, 58>(a);
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

// The rows of a block's span (f32 scores and dP: of a block) and the
// dynamic shared memory of a block of masked_softmax_bwd (256 threads) for
// n-token units in s_dtype and dp_dtype, on 16-byte aligned tensors.
// Returns a cudaError_t.
extern "C" int masked_softmax_bwd_block(int n, int s_dtype, int dp_dtype, int* rows,
                                        int* smem_bytes) {
  if (n < 1 || n > 64 || s_dtype < 0 || s_dtype > 1 || dp_dtype < 0 || dp_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s_dtype == 0 && dp_dtype == 0) {  // the direct design: no staging
    *rows = units_per_block(n) * n;
    *smem_bytes = 0;
    return 0;
  }
  const int size = s_dtype == 0 ? 4 : 2;
  const Layout L = Layout::of(n, n <= 32 ? 8 : 16, size, dp_dtype == 0 ? 4 : 2, size);
  *rows = L.span_rows;
  *smem_bytes = L.bytes();
  return 0;
}
