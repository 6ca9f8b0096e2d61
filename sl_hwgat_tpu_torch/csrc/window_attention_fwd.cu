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
// i.e. 60 us at 3.35 TB/s, against 3.2 GFLOP (3 us on the bf16 tensor cores,
// 48 us of f32 FMAs on the CUDA cores). The design keeps everything except
// q/k/v/o on chip and reads each input byte from device memory once, with
// 16-byte accesses.
//
// 32-token units (window_attention_fwd_kernel, HWGATE): one warp per unit,
// kWarps units per block, no block-wide barriers. The warp stages its unit
// in its own shared memory: q by cp.async in 16-byte chunks, rows padded by
// 16 bytes, k as f32 rows (bf16 converted on the way, every load in flight
// first); v by cp.async into q's space once the query rows are in
// registers, so that its load overlaps the scores. Lane i owns query row i:
// scores, prune, mask and softmax come from attention_row
// (window_attention_common.cuh), the routine the backward recomputes A
// with, so A and the prune decisions are the backward's bit for bit. The
// scores stay f32 FMA chains over d on the CUDA cores in both types (tensor
// core sums flip T(A) roundings, which the bf16 dV bar does not absorb).
// A V runs on two 16-row strips of the unit:
//   f32: T(A) into a swizzled 32 x 32 f32 tile over K's rows, then 4 x 8
//        register tiles (tile_product_of of window_attention_wide.cuh) over
//        j ascending from 0, stored in 16-byte chunks: o is the bits of the
//        lane-per-column design before it;
//   bf16: T(A) into a padded bf16 tile, the A operand by ldmatrix, V by
//        ldmatrix.trans, mma.sync m16n8k16 with f32 sums; O through the
//        warp's shared memory and out in 16-byte chunks.
// The design before it (a lane per output column, V by 2- or 4-byte loads,
// A V on the CUDA cores from a probability tile) spent ~1,500 shared loads
// a lane per unit; this one 550-710, 512 of them the scores' broadcasts.
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
using wide::stage_keys;
using wide::stage_unit;

constexpr int kWarps = 4;          // 32-token units a block, one a warp

// Rows of the staged q, then v, tile: q rows padded by 16 bytes
// (wide::kUnitPad); f32 v rows DH apart (tile_product_of reads them as
// whole rows), bf16 v rows padded by 16 bytes (ldmatrix.trans). v takes
// q's space once the query rows are in registers, so its load overlaps the
// scores.
template <typename T, int DH> constexpr int kPad = wide::kUnitPad<T, DH>;
template <typename T, int DH>
constexpr int kVStride = std::is_same<T, float>::value ? DH : kPad<T, DH>;

// Shared memory of one warp, bytes: K as f32 rows (then T(A), then, in
// bf16, O over it and the q/v space), q then v.
template <typename T, int DH>
constexpr int kWarpBytes = kN * DH * 4 + kN * kPad<T, DH> * static_cast<int>(sizeof(T));
template <typename T, int DH> constexpr int kBlockBytes = kWarps * kWarpBytes<T, DH>;

// A V for a unit in f32: T(A) (row `lane` in e / sum) into the swizzled
// tile `at` over K's rows, then two 16-row strips of 4 x 8 register tiles.
template <int DH, typename TO>
__device__ __forceinline__ void attend_values(const float (&e)[kN], float sum, float* at,
                                              const float* vt, TO* __restrict__ out, int lane) {
#pragma unroll
  for (int c = 0; c < kN; c += 4)
    *reinterpret_cast<float4*>(at + wide::Swizzled32::at(lane, c)) =
        make_float4(e[c] / sum, e[c + 1] / sum, e[c + 2] / sum, e[c + 3] / sum);
  __syncwarp();
  constexpr int kHalves = DH / 32;
  float acc[4][4 * kHalves];
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    wide::tile_product_of<false, kN, kHalves>(wide::Swizzled32{at}, wide::Shared<DH>{vt}, r0,
                                             lane, acc);
    wide::store_tile_of<false, DH>(out, acc, r0, lane, kN, 1.f);
  }
}

// A V for a unit in bf16: T(A) into a padded bf16 tile over K's rows, the A
// operand by ldmatrix, V by ldmatrix.trans, f32 sums on the tensor cores
// (wide::attend_strips); then O through the warp's shared memory (over K's
// rows and the q/v space), out in 16-byte chunks (wide::store_unit_rows).
template <int DH, typename TO>
__device__ __forceinline__ void attend_values(const float (&e)[kN], float sum, float* kspace,
                                              const __nv_bfloat16* vt, TO* __restrict__ out,
                                              int lane) {
  float acc[2][DH / 8][4];
  wide::attend_strips<DH, kPad<__nv_bfloat16, DH>>(
      e, sum, reinterpret_cast<__nv_bfloat16*>(kspace), vt, lane, acc);
  wide::store_unit_rows<DH>(acc, reinterpret_cast<TO*>(kspace), out, DH, lane);
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
  extern __shared__ __align__(16) unsigned char unit_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;
  const long long base = unit * kN * DH;
  float* ks = reinterpret_cast<float*>(unit_smem + warp * kWarpBytes<T, DH>);
  T* qt = reinterpret_cast<T*>(ks + kN * DH);
  T* vt = qt;  // once the query rows are in registers

  stage_unit<T, DH, kPad<T, DH>>(q + base, qt, lane);
  stage_keys<DH>(k + base, ks, lane);
  wide::cp_async_wait_all();
  __syncwarp();

  // Scores, prune, mask and softmax of row `lane`; K rows are broadcast reads.
  float e[kN], sum;
  {
    float qr[DH];
    load_scaled_row<T, DH>(qt + lane * kPad<T, DH>, scale, qr);
    __syncwarp();  // every query row is in registers: v takes q's space
    stage_unit<T, DH, kVStride<T, DH>>(v + base, vt, lane);
    const auto allowed_row = [&] {
      return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN + lane];
    };
    attention_row<kN, DH>(qr, ks, kN, prune_u, allowed_row, zero_quirk, e, sum);
  }
  wide::cp_async_wait_all();
  __syncwarp();  // K is dead and V in place in every lane
  attend_values<DH>(e, sum, ks, vt, o + base, lane);
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
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_kernel<T, TO, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kBlockBytes<T, DH>);
  if (err != cudaSuccess) return err;
  window_attention_fwd_kernel<T, TO, DH><<<static_cast<unsigned>(blocks), kWarps * 32,
                                           kBlockBytes<T, DH>, a.stream>>>(
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

// The dynamic shared memory (bytes) and threads of one block of the
// 32-token kernel for head dim `dh` and input dtype code `dtype`. Returns a
// cudaError_t.
extern "C" int window_attention_fwd_block(int dh, int dtype, int* smem, int* threads) {
  if ((dh != 32 && dh != 64) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = dtype == 0 ? (dh == 32 ? kBlockBytes<float, 32> : kBlockBytes<float, 64>)
                     : (dh == 32 ? kBlockBytes<__nv_bfloat16, 32> : kBlockBytes<__nv_bfloat16, 64>);
  *threads = kWarps * 32;
  return 0;
}
