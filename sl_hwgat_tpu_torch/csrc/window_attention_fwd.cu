// Fused adjacency-masked window attention, forward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_attention.py::_fwd_kernel (masking in
// _masked_attn_matrix) and computes the same function as that kernel's layout
// twins (_fwd_kernel_batched, _fwd_kernel_t, _fwd_kernel_ts,
// _fwd_kernel_ts_batched, _fwd_kernel_wide, _fwd_kernel_wide_batched) on the
// token-major (U, N, DH) layout.
//
// Per unit of N tokens x DH, in f32 or bf16 (N = 32 with DH 32 or 64; or
// N <= 64 with DH 64, HGATE's 58-token units):
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
// read from device memory once, with 16-byte loads. The 32-token kernel's
// products run on the CUDA cores in f32.
//
// Work split, 32-token units: one warp per unit, kWarps units per block,
// no block-wide barriers. Lane i owns query row i for the scores and both
// softmaxes; for A V lane d owns output columns d (and d + 32), so the stores
// coalesce. The score/prune/mask/softmax code of these units is in
// window_attention_common.cuh, shared with the backward kernel, which
// recomputes A from it bit for bit.
// Units of up to 64 tokens (window_attention_fwd_wide_kernel, HGATE's 58):
// one block of 4 warps per unit, each on 16 query rows; the scaled q and k
// staged in shared memory as f32 tiles, v by cp.async (43 KB in bf16, 51 KB
// in f32); scores and softmax on the mma.sync accumulator layout
// (window_attention_wide.cuh, shared with the backward). The scores are
// exact f32 products summed in the plain version's order on the CUDA cores,
// in both types; bf16 runs O = A V on the tensor cores (mma.sync m16n8k16,
// f32 sums), A passing from the accumulators to the A operand in registers;
// f32 runs A V as exact f32 products on the CUDA cores, in 4 x 8 register
// tiles over A written to the warp's own rows of the q tile.
// The TPU kernel pads HGATE's 58 tokens to 64 and stacks two units; here the
// padded keys simply do not exist (no weight, no part in either softmax).
// Bound at HGATE's batch 16 (3072 units of 58 tokens): bytes, 91 MB in bf16
// (27 us at 3.35 TB/s) against 2.6 GFLOP (3 us on the bf16 tensor cores).

#include "window_attention_common.cuh"
#include "window_attention_wide.cuh"

namespace {

using namespace wattn;

constexpr int kWarps = 4;

template <typename T, typename TO, int DH>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, TO* __restrict__ o,
                            const uint32_t* __restrict__ masks,
                            const int* __restrict__ sel,
                            const float* __restrict__ prune_u, long long units,
                            float scale, int zero_quirk, int dual, int stack,
                            int per_group, int groups, long long unit_offset) {
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

  stage_rows<T, DH, 32>(k + base, ks, lane, kN);
  float qr[DH];
  load_scaled_row<T, DH>(q + base + static_cast<long long>(lane) * DH, scale, qr);
  __syncwarp();

  // Scores, prune, mask and softmax of row `lane`; K rows are broadcast reads.
  float e[kN], sum;
  const auto allowed_row = [&] {
    return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN + lane];
  };
  attention_row<kN, DH>(qr, ks, kN, prune_u, allowed_row, zero_quirk, e, sum);

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
  for (int j = 0; j < kN; ++j) ps[lane * kPStride + j] = round_to<T>(e[j] / sum);
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

// Units of n <= 64 tokens, DH = 64: one block of wide::kThreads per unit,
// warp w on query rows 16w .. 16w + 15 (window_attention_wide.cuh).
template <typename T, typename TO>
__global__ void __launch_bounds__(wide::kThreads, wide::kMinBlocks)
window_attention_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, TO* __restrict__ o,
                                 const unsigned long long* __restrict__ masks,
                                 const int* __restrict__ sel, const float* __restrict__ prune_u,
                                 int n, float scale, int zero_quirk, int dual, int stack,
                                 int per_group, int groups, long long unit_offset) {
  using namespace wide;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  float* qs = reinterpret_cast<float*>(wide_smem);  // q * T(scale); f32: then A
  float* ks = qs + kTileElems<float>;
  T* vs = reinterpret_cast<T*>(ks + kTileElems<float>);

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const long long unit = blockIdx.x;
  const long long base = unit * n * kDH;
  stage_tile(v + base, vs, n, tid);
  stage_f32(q + base, qs, n, tid, round_to<T>(scale));
  stage_f32(k + base, ks, n, tid, 1.f);
  cp_async_wait_all();
  __syncthreads();
  if (r0 >= n) return;  // rows past the unit: no barrier follows

  const auto allowed_row = [&](int row) {
    return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * n + row];
  };
  float s[8][4];
  strip_attention(qs, ks, r0, lane, n, prune_u, allowed_row, zero_quirk, s);
  if constexpr (kTensorCores<T>) {
    // A rounded to bf16 in registers, fed back as the A operand of A V.
    uint32_t p[4][4];
    to_a_operand(s, p);
    float acc[8][4];
    strip_ab(p, vs, lane, acc);
    store_strip(o + base, acc, r0, lane, n, 1.f);
  } else {
    // A into the warp's own rows of the q tile, then A V in register tiles.
    __syncwarp();
    write_strip(qs, s, r0, lane);
    __syncwarp();
    float acc[4][8];
    tile_product<false>(qs, vs, r0, lane, acc);
    store_tile<false>(o + base, acc, r0, lane, n, 1.f);
  }
}

struct Args {
  const void* q; const void* k; const void* v; void* o;
  const void* masks; const int* sel; const float* prune_u;
  long long units; int tokens; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T, typename TO, int DH>
cudaError_t launch(const Args& a) {
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  window_attention_fwd_kernel<T, TO, DH><<<static_cast<unsigned>(blocks), kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<TO*>(a.o), static_cast<const uint32_t*>(a.masks), a.sel, a.prune_u, a.units,
      a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_wide(const Args& a) {
  constexpr int kBytes = 2 * wide::kTileElems<float> * static_cast<int>(sizeof(float)) +
                         wide::kTileElems<T> * static_cast<int>(sizeof(T));
  if (a.units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_wide_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  window_attention_fwd_wide_kernel<T, TO>
      <<<static_cast<unsigned>(a.units), wide::kThreads, kBytes, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          static_cast<TO*>(a.o), static_cast<const unsigned long long*>(a.masks), a.sel,
          a.prune_u, a.tokens, a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups,
          a.unit_offset);
  return cudaGetLastError();
}

// 32-token units take DH 32 or 64 and 32-bit row masks; other units of up
// to 64 tokens take DH 64 and 64-bit row masks.
template <typename T, typename TO>
cudaError_t launch_dh(int dh, const Args& a) {
  if (a.tokens == kN && dh == 32) return launch<T, TO, 32>(a);
  if (a.tokens == kN && dh == 64) return launch<T, TO, 64>(a);
  if (a.tokens >= 1 && a.tokens <= kWideN && dh == 64) return launch_wide<T, TO>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `masks`: (2, tokens) row bitmasks,
// 32-bit for 32-token units, else 64-bit. Returns a cudaError_t (0 = launched).
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* masks, const void* sel, const void* prune_u,
                                    long long units, int tokens, int dh, int in_dtype,
                                    int out_dtype,
                                    float scale, int zero_quirk, int dual, int stack,
                                    int per_group, int groups, long long unit_offset,
                                    void* stream) {
  if (units <= 0 || stack <= 0 || (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, masks, static_cast<const int*>(sel),
               static_cast<const float*>(prune_u), units, tokens, scale, zero_quirk, dual,
               stack, per_group, groups, unit_offset, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) err = launch_dh<float, float>(dh, a);
  else if (in_dtype == 0 && out_dtype == 1) err = launch_dh<float, __nv_bfloat16>(dh, a);
  else if (in_dtype == 1 && out_dtype == 0) err = launch_dh<__nv_bfloat16, float>(dh, a);
  else if (in_dtype == 1 && out_dtype == 1) err = launch_dh<__nv_bfloat16, __nv_bfloat16>(dh, a);
  return static_cast<int>(err);
}
