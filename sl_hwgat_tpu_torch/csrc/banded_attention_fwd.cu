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
// 6 edges per query; 9 us as f32 FMAs).
//
// A block of kFwdThreads = 128 threads owns frames_fwd(V) = 128 / V frames
// of one plane (8 at WGATE's V = 16, 4 at GATE's 29). Every load is in
// flight at once: q of its frames, k and v of its frames +-1, staged in T by
// cp.async with swizzled chunks (Staged). Blocks of 256 threads (half the
// halo) ran slower, of 64 no faster (bench.ablate banded_fwd's threads_256
// and threads_64 variants). One thread per query row computes each
// edge's score once, as an f32 dot in d order on the CUDA cores, caching the
// scores, then exp(s - max), by edge rank in shared memory (a row's edges in
// (plane, joint) order); rows with more edges than the cache holds (`cap`,
// at most kMaxCache: a full band has 3V) recompute their later scores with
// the same arithmetic. A.V then reads each edge's term once. The softmax is
// the backward's: the max, then the sum of exp(s - max), then
// exp(s - max) / sum, so o is the design before it bit for bit.

#include "banded_attention_common.cuh"

namespace {

using namespace battn;

constexpr int kFwdThreads = 128;
constexpr int kMaxCache = 32;  // cached edges per query row

__host__ __device__ __forceinline__ int frames_fwd(int nv) { return kFwdThreads / nv; }

// Shared memory of one block, in bytes: q of its frames, k and v of its
// frames +-1 in T; the band's row bits (3 x 32 words); the cache, with a row
// stride of the block's threads.
template <typename T>
__host__ __device__ __forceinline__ int fwd_smem_bytes(int nv, int cap) {
  const int fb = frames_fwd(nv);
  return (fb + 2 * (fb + 2)) * nv * kDH * static_cast<int>(sizeof(T)) + 3 * kMaxV * 4 +
         cap * kFwdThreads * 4;
}

// No __launch_bounds__: under (256) ptxas held every instantiation to 80
// registers and spilled 24-32 bytes.
template <typename T, typename TO>
__global__ void banded_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, TO* __restrict__ o,
                            const uint32_t* __restrict__ rows, int frames, int nv, int cap,
                            float scale) {
  extern __shared__ __align__(16) uint4 smem[];
  using S = Staged<T>;
  const int fb = frames_fwd(nv);
  uint4* qs = smem;                          // query row lf * nv + i: frame f0 + lf
  uint4* ks = qs + fb * nv * S::kChunks;     // key row s * nv + j: frame f0 - 1 + s
  uint4* vs = ks + (fb + 2) * nv * S::kChunks;
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + (fb + 2) * nv * S::kChunks);
  float* cache = reinterpret_cast<float*>(bits + 3 * kMaxV);  // edge e of row r: e * stride + r

  const int blocks_per_plane = (frames + fb - 1) / fb;
  const long long plane = blockIdx.x / blocks_per_plane;
  const int f0 = static_cast<int>(blockIdx.x % blocks_per_plane) * fb;
  const long long base = plane * frames * nv * kDH;

  S::stage(q + base, f0, f0 + fb - 1, frames, nv, qs);
  S::stage(k + base, f0 - 1, f0 + fb, frames, nv, ks);
  S::stage(v + base, f0 - 1, f0 + fb, frames, nv, vs);
  for (int t = threadIdx.x; t < 3 * kMaxV; t += blockDim.x) bits[t] = __ldg(rows + t);
  cp_async_wait_all();
  __syncthreads();

  const int r = threadIdx.x;
  const int lf = r / nv;
  const int i = r - lf * nv;
  const int f = f0 + lf;
  if (lf >= fb || f >= frames) return;
  constexpr int stride = kFwdThreads;
  // the row's edge bits of plane p, the clip's ends cut
  const uint32_t b0 = f > 0 ? bits[i] : 0u, b1 = bits[kMaxV + i];
  const uint32_t b2 = f < frames - 1 ? bits[2 * kMaxV + i] : 0u;
  const auto b = [&](int p) { return p == 0 ? b0 : p == 1 ? b1 : b2; };
  const int kr0 = lf * nv;  // key row of joint 0 of frame f - 1; plane p at kr0 + p * nv
  float qr[kDH];
  S::row(qs, r, qr);

  // the max of the scores, caching them
  float m = -INFINITY;
  int e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      const float s = S::dot(qr, ks, kr0 + p * nv + __ffs(bb) - 1) * scale;
      m = fmaxf(m, s);
      if (e < cap) cache[e * stride + r] = s;
    }
  // the sum of exp(s - max), caching the terms
  float sum = 0.f;
  e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      float s;
      if (e < cap) {
        s = cache[e * stride + r];
      } else {
        s = S::dot(qr, ks, kr0 + p * nv + __ffs(bb) - 1) * scale;
      }
      const float t = expf(s - m);
      sum += t;
      if (e < cap) cache[e * stride + r] = t;
    }
  // o = sum_self T(A) v + sum_prev/next A v
  float self[kDH] = {}, band[kDH] = {};
  e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      const int kr = kr0 + p * nv + __ffs(bb) - 1;
      float t;
      if (e < cap) {
        t = cache[e * stride + r];
      } else {
        t = expf(S::dot(qr, ks, kr) * scale - m);
      }
      const float a = t / sum;
      if (p == 1) S::axpy(round_to<T>(a), vs, kr, self);
      else S::axpy(a, vs, kr, band);
    }
#pragma unroll
  for (int d = 0; d < kDH; ++d) self[d] += band[d];
  store_row(o + base + (static_cast<long long>(f) * nv + i) * kDH, self);
}

struct Args {
  const void* q; const void* k; const void* v; void* o; const uint32_t* rows;
  long long planes; int frames; int nv; int cap; float scale; cudaStream_t stream;
};

template <typename T, typename TO>
cudaError_t launch(const Args& a) {
  const int fb = frames_fwd(a.nv);
  const long long blocks = a.planes * ((a.frames + fb - 1) / fb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int bytes = fwd_smem_bytes<T>(a.nv, a.cap);
  const cudaError_t err = cudaFuncSetAttribute(banded_attention_fwd_kernel<T, TO>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  banded_attention_fwd_kernel<T, TO><<<static_cast<unsigned>(blocks), kFwdThreads, bytes,
                                       a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<TO*>(a.o), a.rows, a.frames, a.nv, a.cap, a.scale);
  return cudaGetLastError();
}

int cache_edges(int edges_per_row) {
  return edges_per_row < kMaxCache ? edges_per_row : kMaxCache;
}

bool valid(int joints, int dtype, int edges_per_row) {
  return joints > 0 && joints <= kMaxV && edges_per_row >= 1 && edges_per_row <= 3 * joints &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. `rows`: (6, 32) uint32 band bits
// (planes 0-2 by query row, 3-5 by key column; the forward reads 0-2);
// `edges_per_row`: the most edges a query row of the band has (1 .. 3 *
// joints), which sizes the edge cache. Returns a cudaError_t (0 = launched).
extern "C" int banded_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* rows, long long planes, int frames,
                                    int joints, int dh, int in_dtype, int out_dtype,
                                    int edges_per_row, float scale, void* stream) {
  if (planes <= 0 || frames <= 0 || dh != kDH || !valid(joints, in_dtype, edges_per_row))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<const uint32_t*>(rows), planes, frames, joints,
               cache_edges(edges_per_row), scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) err = launch<float, float>(a);
  else if (in_dtype == 0 && out_dtype == 1) err = launch<float, __nv_bfloat16>(a);
  else if (in_dtype == 1 && out_dtype == 0) err = launch<__nv_bfloat16, float>(a);
  else if (in_dtype == 1 && out_dtype == 1) err = launch<__nv_bfloat16, __nv_bfloat16>(a);
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) and threads of one block of
// banded_attention_fwd for these arguments (dtype: q's). Returns a
// cudaError_t.
extern "C" int banded_attention_fwd_block(int joints, int dtype, int edges_per_row, int* smem,
                                          int* threads) {
  if (!valid(joints, dtype, edges_per_row)) return static_cast<int>(cudaErrorInvalidValue);
  const int cap = cache_edges(edges_per_row);
  *smem = dtype == 0 ? fwd_smem_bytes<float>(joints, cap)
                     : fwd_smem_bytes<__nv_bfloat16>(joints, cap);
  *threads = kFwdThreads;
  return 0;
}
