// Masked softmax of per-unit attention scores, forward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/hybrid_attention.py::_softmax_fwd_kernel (the
// masking of pallas_attention.py::_masked_attn_matrix) in the hybrid window
// attention: two batched GEMMs (torch.bmm) around this pass.
//
// Per row of the scores S (U, n, n) in TS (f32, or bf16 under the JAX
// package's PALLAS_HYBRID_S_BF16 path), n <= 64 (HWGATE 32, HGATE 58), each
// score upcast to f32 on load:
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
// Bound on an H100 SXM: bytes. A call reads S (4 or 2 bytes) and writes P
// (4 or 2 bytes) once per entry: 100.7 / 75.5 / 50.3 MB at HWGATE's 12288 x
// 32 x 32 (f32 S and P / f32 S, bf16 P / bf16 S and P), 30 / 23 / 15 us at
// 3.35 TB/s. The design before this one (a warp per row, one
// column a lane) ran the row's reductions, exps and divisions with 32 lanes
// for 32 (or 58) entries and issued about as many instructions as the bytes
// allowed time for (0.082 ms at HWGATE's shape, 0.056 at HGATE's, on an
// NVIDIA H100 80GB HBM3 at 700 W). Here a row takes 8 lanes (16 for n > 32),
// four columns a lane (masked_softmax_common.cuh): a warp works 4 (2) rows
// at once, the reductions take 3 (4) shuffle steps, P is the exp times one
// reciprocal of the sum, and each lane loads and stores its columns 16 bytes
// (HGATE's unaligned 58-float rows: 8) at a time, bf16 P 4 bytes. A
// block of 8 warps takes 128 / n whole units and looks up each unit's mask
// plane once. Staging whole units in shared memory by cp.async (coalesced,
// whatever n) and loading two row groups a warp ahead were both slower on
// that card: the registers they cost took warps away (bench/ablate.py
// softmax times the kernel and its no-softmax variant).

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

template <typename TS, typename TP, int kLanes, int kMap>
__global__ void __launch_bounds__(kThreads)
masked_softmax_fwd_kernel(const TS* __restrict__ s, TP* __restrict__ p,
                          const unsigned long long* __restrict__ masks,
                          const int* __restrict__ sel, const float* __restrict__ prune_u,
                          long long units, int n, int zero_quirk, int dual, int stack,
                          int per_group, int groups, long long unit_offset, int vec) {
  __shared__ int plane[kMinRows];
  const auto B = BlockRows<kLanes>::of(blockIdx.x, units, n);
  B.planes(plane, dual, sel, stack, per_group, groups, unit_offset);
  __syncthreads();
  for (int base = B.first(); base < B.rows(); base += B.kStep) {
    const int r = base + B.g;
    float x[kPer] = {};
    if (r < B.rows()) load_cols<kLanes, kMap>(s + B.offset(r), B.l, n, vec, x);
    float a[kPer];
    masked_softmax_row<kLanes, kMap>(x, B.l, n, B.allowed(masks, plane, r), prune_u, zero_quirk,
                                     a);
    if (r < B.rows()) store_cols<kLanes, kMap>(p + B.offset(r), B.l, n, vec, a);
  }
}

struct Args {
  const void* s; void* p; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long units; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TS, typename TP, int kLanes, int kMap>
cudaError_t launch(const Args& a) {
  const int upb = units_per_block(a.n);
  const long long blocks = (a.units + upb - 1) / upb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(a.s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
  masked_softmax_fwd_kernel<TS, TP, kLanes, kMap><<<static_cast<unsigned>(blocks), kThreads, 0,
                                                    a.stream>>>(
      static_cast<const TS*>(a.s), static_cast<TP*>(a.p), a.masks, a.sel, a.prune_u, a.units, a.n, a.zero_quirk, a.dual,
      a.stack, a.per_group, a.groups, a.unit_offset, vec);
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
cudaError_t launch_types(const Args& a, int p_dtype) {
  if (p_dtype == 0) return launch_lanes<TS, float>(a);
  if (p_dtype == 1) return launch_lanes<TS, __nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// s: (units, n, n) scores in s_dtype; p: the same shape in p_dtype (each
// 0 = float32, 1 = bfloat16); masks: (2, n) 64-bit row masks. Returns a
// cudaError_t (0 = launched).
extern "C" int masked_softmax_fwd(const void* s, void* p, const void* masks, const void* sel,
                                  const void* prune_u, long long units, int n, int s_dtype,
                                  int p_dtype, int zero_quirk, int dual, int stack, int per_group,
                                  int groups, long long unit_offset, void* stream) {
  if (units <= 0 || n < 1 || n > 64 || stack <= 0 ||
      (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{s, p, static_cast<const unsigned long long*>(masks),
               static_cast<const int*>(sel), static_cast<const float*>(prune_u), units, n,
               zero_quirk, dual, stack, per_group, groups, unit_offset,
               static_cast<cudaStream_t>(stream)};
  if (s_dtype == 0) return static_cast<int>(launch_types<float>(a, p_dtype));
  if (s_dtype == 1) return static_cast<int>(launch_types<__nv_bfloat16>(a, p_dtype));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The units and threads of one block of masked_softmax_fwd (and of
// masked_softmax_bwd) for n-token units. Returns a cudaError_t.
extern "C" int masked_softmax_fwd_block(int n, int* units, int* threads) {
  if (n < 1 || n > 64) return static_cast<int>(cudaErrorInvalidValue);
  *units = units_per_block(n);
  *threads = kThreads;
  return 0;
}
