// The kernel bench's softmax_only probe in one pass, for Hopper (sm_90a).
//
// Replaces bench_kernel.py:1285 (softmax_only): per 128-token supertile of
// f32 (SN, DH) tiles, S = [q_g | q_g] and a = masked_softmax(S)[:, :64].
// Only the diagonal 32 x 32 unit blocks of units 0 and 1 reach a[:, :64]
// (rows 0-31 by columns 0-31, rows 32-63 by columns 32-63); every other
// entry there is a cross-unit entry, exactly 0 after the f32 softmax. So the
// output tile is P of those two blocks under the window mask (K7's masked
// softmax: zero quirk, no prune) and zeros everywhere else.
//
// Bound on an H100 SXM: bytes. The function reads the two blocks (8 KB a
// tile: 25.2 MB at the bench's 3072 tiles) and writes the whole (SN, DH)
// tile (32 KB: 100.7 MB), 0.038 ms at 3.35 TB/s (the bench reckons the TPU
// probe's 0.060: it reads the whole tile). The port's earlier composition
// gathered the blocks, ran K7, zero-filled the output and scattered the
// blocks into it: five launches and the blocks' bytes three more times.
//
// Design: a block of 8 warps per tile. The 64 rows of the two blocks go
// through K7's row routine (masked_softmax_common.cuh: a row per 8 lanes,
// four columns a lane, 16-byte loads), so P is K7's bit for bit; each lane
// stores its four probabilities with one 16-byte store. The rest of the
// tile (the other half of those rows, rows 64 .. SN - 1) is zero-filled in
// 16-byte stores, consecutive threads on consecutive chunks.

#include "masked_softmax_common.cuh"

namespace {

using namespace msoft;

constexpr int kBlockN = 32;  // the unit blocks: 32 tokens
constexpr int kLanes = 8;    // a row per 8 lanes, four columns a lane

__global__ void __launch_bounds__(kThreads)
softmax_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const unsigned long long* __restrict__ masks, int sn, int dh) {
  const long long tile = blockIdx.x;
  const float* src = x + tile * sn * dh;
  float* dst = out + tile * sn * dh;
  const int lane = threadIdx.x & 31, g = lane / kLanes, l = lane % kLanes;
  // rows 0 .. 63, 32 / kLanes a warp at a time
  for (int r = (threadIdx.x >> 5) * (32 / kLanes) + g; r < 2 * kBlockN;
       r += kWarps * (32 / kLanes)) {
    const int col = r / kBlockN * kBlockN;  // the row's block: its columns
    float s[kPer], a[kPer];
    load_cols<kLanes, kQuads>(src + r * dh + col, l, kBlockN, true, s);
    masked_softmax_row<kLanes, kQuads>(s, l, kBlockN, __ldg(masks + r % kBlockN), nullptr, 1, a);
    store_cols<kLanes, kQuads>(dst + r * dh + col, l, kBlockN, true, a);
  }
  // zeros: every 16-byte chunk outside the two blocks
  const int chunks = dh / 4;
  for (int c = threadIdx.x; c < sn * chunks; c += kThreads) {
    const int r = c / chunks, x4 = c % chunks * 4;
    if (r < 2 * kBlockN && x4 >= r / kBlockN * kBlockN && x4 < (r / kBlockN + 1) * kBlockN)
      continue;
    *reinterpret_cast<float4*>(dst + r * dh + x4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// x, out: (tiles, sn, dh) f32, 16-byte aligned, sn >= 64, dh >= 64 and a
// multiple of 4; masks: (2, 32) 64-bit row bitmasks (plane 0 is read).
// Returns a cudaError_t (0 = launched).
extern "C" int softmax_probe(const void* x, void* out, const void* masks, long long tiles, int sn,
                             int dh, void* stream) {
  if (tiles <= 0 || tiles > 0x7fffffffLL || sn < 2 * kBlockN || dh < 2 * kBlockN || dh % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  softmax_probe_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const unsigned long long*>(masks), sn, dh);
  return static_cast<int>(cudaGetLastError());
}

// The tiles and threads of one block. Returns a cudaError_t.
extern "C" int softmax_probe_block(int* tiles, int* threads) {
  *tiles = 1;
  *threads = kThreads;
  return 0;
}
