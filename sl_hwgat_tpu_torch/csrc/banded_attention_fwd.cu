// Banded (block-tridiagonal) graph attention, forward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_banded.py::_fwd_kernel_packed (K8, the
// identity +-1 frame band of GATE/WGATE, through both of its entries,
// pallas_packed_banded_attention and its plane form) and
// ::_fwd_kernel (K9, any (3, V, V) band), on the token-major (P, F * V, 16)
// layout. Per plane, for query joint i of frame f:
//   s_j  = (q_i . k_j) * scale             f32 sums, over the edges j of the
//                                          band's [prev | self | next] rows
//   A    = softmax over those edges        f32
//   o_i  = sum_self T(A_ij) v_j + sum_prev/next A_ij v_j    f32, stored as TO
// The TPU kernel packs frames into 128-row tiles padded to Vp joints, and
// computes the identity bands as per-token dots on the VPU; here only the
// band's edges are visited, which is the same arithmetic with no padding.
//
// Bound on an H100 SXM: bytes. A call reads q, k, v and writes o once:
// 4 * P * F * V * 16 elements, 403 MB in f32 at WGATE's P = 512, F * V =
// 3072 (0.120 ms at 3.35 TB/s), against 0.6 GFLOP of edge products (about
// 6 edges per query; 9 us as f32 FMAs). The design reads every input byte
// about once: a block stages K
// and V of its 128 / V frames and one frame each side into shared memory
// (f32), and each thread reads its query row once and writes its output row
// once, with 16-byte accesses. The products run as f32 FMAs on the CUDA
// cores.

#include "banded_attention_common.cuh"

namespace {

using namespace battn;

// Rows of one staged tensor: (128 / V + 2) * V <= 128 + 2 * kMaxV.
constexpr int kSlotRows = kThreads + 2 * kMaxV;

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
banded_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, TO* __restrict__ o,
                            const uint32_t* __restrict__ rows, int frames, int nv,
                            float scale) {
  __shared__ __align__(16) float ks[kSlotRows * kDH];
  __shared__ __align__(16) float vs[kSlotRows * kDH];

  const int fb = frames_per_block(nv);
  const int blocks_per_plane = (frames + fb - 1) / fb;
  const long long plane = blockIdx.x / blocks_per_plane;
  const int f0 = static_cast<int>(blockIdx.x % blocks_per_plane) * fb;
  const long long base = plane * frames * nv * kDH;

  // Slot s holds frame f0 - 1 + s.
  stage_frames<T>(k + base, f0 - 1, f0 + fb, frames, nv, ks);
  stage_frames<T>(v + base, f0 - 1, f0 + fb, frames, nv, vs);
  __syncthreads();

  const int lf = threadIdx.x / nv;
  const int i = threadIdx.x % nv;
  const int f = f0 + lf;
  if (lf >= fb || f >= frames) return;
  const long long row = base + (static_cast<long long>(f) * nv + i) * kDH;

  float qr[kDH];
  load_row<T>(q + row, qr);
  const RowBits b = row_bits(rows, i, f, frames);
  const float* keys = ks + lf * nv * kDH;  // frame f - 1; plane p is slot lf + p
  const float* vals = vs + lf * nv * kDH;
  const RowStats st = row_stats(qr, keys, b, nv, scale);

  float self[kDH] = {}, band[kDH] = {};
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bits = b.p[p]; bits; bits &= bits - 1) {
      const int e = (p * nv + __ffs(bits) - 1) * kDH;
      const float a = prob(dot(qr, keys + e) * scale, st);
      if (p == 1) axpy(round_to<T>(a), vals + e, self);
      else axpy(a, vals + e, band);
    }
#pragma unroll
  for (int d = 0; d < kDH; ++d) self[d] += band[d];
  store_row(o + row, self);
}

struct Args {
  const void* q; const void* k; const void* v; void* o; const uint32_t* rows;
  long long planes; int frames; int nv; float scale; cudaStream_t stream;
};

template <typename T, typename TO>
cudaError_t launch(const Args& a) {
  const int fb = frames_per_block(a.nv);
  const long long blocks = a.planes * ((a.frames + fb - 1) / fb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  banded_attention_fwd_kernel<T, TO><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<TO*>(a.o), a.rows, a.frames, a.nv, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `rows`: (6, 32) uint32 band bits
// (planes 0-2 by query row, 3-5 by key column). Returns a cudaError_t
// (0 = launched).
extern "C" int banded_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* rows, long long planes, int frames,
                                    int joints, int dh, int in_dtype, int out_dtype,
                                    float scale, void* stream) {
  if (planes <= 0 || frames <= 0 || joints <= 0 || joints > kMaxV || dh != kDH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<const uint32_t*>(rows), planes, frames, joints, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) err = launch<float, float>(a);
  else if (in_dtype == 0 && out_dtype == 1) err = launch<float, __nv_bfloat16>(a);
  else if (in_dtype == 1 && out_dtype == 0) err = launch<__nv_bfloat16, float>(a);
  else if (in_dtype == 1 && out_dtype == 1) err = launch<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(err);
}
