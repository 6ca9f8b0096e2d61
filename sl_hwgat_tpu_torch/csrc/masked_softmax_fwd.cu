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
// 3.35 TB/s; 41.3 MB with bf16 S and P at HGATE's 3072 x 58 x 58, 12 us. A
// row takes 8 lanes (16 for n > 32), four columns a lane
// (masked_softmax_common.cuh): a warp works 4 (2) rows at once, the
// reductions take 3 (4) shuffle steps, P is the exp times one reciprocal of
// the sum. (The first design, a warp per row, took 0.082 ms at HWGATE's
// shape, 0.056 at HGATE's; NVIDIA H100 80GB HBM3, 700 W.)
//
// One design for every score and P type, spans staged in shared memory
// (staged_spans in masked_softmax_common.cuh); P is the earlier design's
// bit for bit. A grid of the resident blocks walks spans of rows, whole
// passes of the block's warps over rows (about 24 KB of S and P a span: 192
// rows at 32 tokens with bf16 S and P, 96 at 58). One thread copies a
// span's scores into one of two input stages with a 1-D bulk copy
// (cp.async.bulk: the copy engine moves the bytes and completes on an
// mbarrier, no other thread spends a register or an instruction on it),
// the next span's copy in flight under this one's rows. The rows write P
// into one of two output stages, which one bulk copy stores back, whole
// 32-byte sectors. A span's head and tail entries, where its ends share a
// 16-byte chunk with another span (33-token units, a tensor off a 16-byte
// boundary, a ragged last span), are stored by the threads; loads take the
// chunks whole. HWGATE's 32 and HGATE's 58 tokens are compiled as
// constants, and the rows of a span of whole, aligned passes run without a
// guard on each row.
//
// Where the time went (bench/ablate.py softmax, NVIDIA H100 80GB HBM3,
// 700.00 W): the earlier design (a block of 128 / n whole units, each
// lane's columns read and written in device memory) read bf16 scores 4 or
// 8 bytes a lane an access and took as long as with f32 scores (0.0395
// against 0.0382 ms at HWGATE); its loads, mask lookups and stores alone
// took 87% of it. Wider accesses, more units a block and a grid of the
// resident blocks did not help. Staged, the copies alone move HWGATE's bf16
// scores and P in 0.019 ms; the rows then bound the kernel (their time
// alone is 90% of it), and it takes 0.0298 ms at HWGATE, 0.0299 at HGATE,
// against the earlier design's 0.0392 and 0.0385 in turns; on f32 scores
// 3-5% less time with f32 P, 5-15% with bf16 P. With n as an argument in
// place of the two constants, the bf16-score forward keeps at most 9
// points of its 15-24% gain. Whole units staged by cp.async lost to the earlier
// design: every thread issued 16-byte copies and held their registers
// through them, taking warps away from the rows; a bulk copy costs the
// rows nothing.

#include <type_traits>

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

// Spans of rows staged in shared memory by bulk copies.
template <typename TS, typename TP, int kLanes, int kMap, int kN>
__global__ void __launch_bounds__(kThreads, kLanes == 16 ? kMinBlocks : 1)
masked_softmax_fwd_staged(const TS* __restrict__ s, TP* __restrict__ p,
                          const unsigned long long* __restrict__ masks,
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
      s, static_cast<const TS*>(nullptr), p, units, n, L, smem, full,
      [&](long long u0, int count) {
        R.planes(plane, u0, count, dual, sel, stack, per_group, groups, unit_offset);
      },
      [&](const TS* ss, const TS*, TP* ps, int rows, int first) {
        // whole: every row of each pass exists and the rows are aligned
        auto pass = [&](auto whole) {
          constexpr bool kWhole = decltype(whole)::value;
          for (int base = R.first(); base < rows; base += R.kStep) {
            const int r = base + R.g;
            float x[kPer] = {};
            if (kWhole || r < rows)
              load_cols<kLanes, kMap, false>(ss + r * n, R.l, n, kWhole || vec, x);
            float a[kPer];
            const unsigned long long allowed =
                R.allowed(staged_masks, plane, r, kWhole ? r + 1 : rows, first, n);
            masked_softmax_row<kLanes, kMap>(x, R.l, n, allowed, prune_u, zero_quirk, a);
            if (kWhole || r < rows)
              store_cols<kLanes, kMap, false>(ps + r * n, R.l, n, kWhole || vec, a);
          }
        };
        if (vec && rows % R.kStep == 0) pass(std::true_type{});
        else pass(std::false_type{});
      });
}

struct Args {
  const void* s; void* p; const unsigned long long* masks; const int* sel;
  const float* prune_u; long long units; int n; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename TS, typename TP, int kLanes, int kMap, int kN = 0>
cudaError_t launch(const Args& a) {
  static Grid grid;
  const Layout L = Layout::of(a.n, kLanes, sizeof(TS), 0, sizeof(TP));
  unsigned blocks = 0;
  const cudaError_t err = grid.size(masked_softmax_fwd_staged<TS, TP, kLanes, kMap, kN>,
                                    a.units * a.n, L, blocks);
  if (err != cudaSuccess) return err;
  const int vec = reinterpret_cast<uintptr_t>(a.s) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
  masked_softmax_fwd_staged<TS, TP, kLanes, kMap, kN><<<blocks, kThreads, L.bytes(), a.stream>>>(
      static_cast<const TS*>(a.s), static_cast<TP*>(a.p), a.masks, a.sel, a.prune_u, a.units,
      a.n, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset, L, vec);
  return cudaGetLastError();
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

// The rows of a block's span and the dynamic shared memory of a block of
// masked_softmax_fwd (256 threads) for n-token units in s_dtype and
// p_dtype, on 16-byte aligned tensors. Returns a cudaError_t.
extern "C" int masked_softmax_fwd_block(int n, int s_dtype, int p_dtype, int* rows,
                                        int* smem_bytes) {
  if (n < 1 || n > 64 || s_dtype < 0 || s_dtype > 1 || p_dtype < 0 || p_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L =
      Layout::of(n, n <= 32 ? 8 : 16, s_dtype == 0 ? 4 : 2, 0, p_dtype == 0 ? 4 : 2);
  *rows = L.span_rows;
  *smem_bytes = L.bytes();
  return 0;
}
