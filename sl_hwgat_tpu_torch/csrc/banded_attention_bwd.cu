// Banded (block-tridiagonal) graph attention, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_banded.py::_bwd_kernel_packed (K8) and
// ::_bwd_kernel (K9) on the token-major (P, F * V, 16) layout, T = f32 or
// bf16 (q's type), dO already in T. With A recomputed as the forward computes
// it (banded_attention_fwd.cu) and over the band's edges only:
//   dP_ij = dO_i . v_j                         f32
//   D_i   = sum_j A_ij dP_ij                   all three planes, in the kernel
//   dS_ij = A_ij (dP_ij - D_i)
//   dQ_i  = scale * sum_self T(dS_ij) k_j + scale * sum_prev/next dS_ij k_j
//   dK_j  = scale * sum_self T(dS_ij) q_i + scale * sum_prev/next dS_ij q_i
//   dV_j  = sum_self T(A_ij) dO_i + sum_prev/next A_ij dO_i
// stored in T: the rounding of _bwd_kernel_packed.
//
// Key frame f receives from the queries of frames f - 1 (their next plane),
// f and f + 1 (their prev plane). The kernel gathers instead of scattering,
// so there are no atomics and a step repeats bit for bit. A block owns
// 128 / V frames of one plane and puts all of its loads in flight at once
// (cp.async): q, dO of its frames +-1 and k, v of its frames +-2, staged in
// T (bf16 stays bf16) with the 16-byte chunks of each row swizzled, so that
// eight consecutive rows read by a quarter-warp fall on distinct banks.
//   row phase: one thread per staged query row, (128 / V + 2) * V rows in
//     one round of ceil(rows / 32) warps. Each edge's score and dP are
//     computed once: the row's edges are cached in shared memory by rank
//     (the popcount of the lower bits of its plane, after the earlier
//     planes' counts), first the scores, then exp(s - max), then A and dP,
//     then dS. The softmax is taken as the forward takes it (row_stats of
//     banded_attention_common.cuh): the max, then the sum of exp(s - max),
//     over the edges in (plane, joint) order, so A is the forward's bit for
//     bit. dQ for the block's own rows.
//   column phase: one thread per own key row gathers dK, then dV, over the
//     edges of its column (the band's transposed bits), reading A_ij and
//     dS_ij from the cache at the edge's rank in row i.
// Rows with more edges than the cache holds (`cap`, at most kMaxCache: a
// full band has 3V) keep the statistics (max, sum, D) of every row, and
// their later edges are recomputed from them where they are used, with the
// same arithmetic; so any band takes the one kernel.
//
// Bound on an H100 SXM: bytes. A call reads q, k, v, dO and writes dq, dk,
// dv once: 7 * P * F * V * 16 elements, 705 MB in f32 at WGATE's shape
// (0.210 ms at 3.35 TB/s), against about 1.5 GFLOP of edge products. Per
// edge the kernel reads five staged rows (k, v, k in the row phase; q, dO
// in the column phase) and a few cached words, where the design before it
// read eleven rows and took each score five times.

#include "banded_attention_common.cuh"

namespace {

using namespace battn;

// Threads of a block: (128 / V + 2) * V query rows rounded up to warps, at
// most 192 for V <= 32. The kernel carries no __launch_bounds__: under
// __launch_bounds__(192) ptxas held the bf16 build to 80 registers with a
// 4-byte spill, under (192, 1) it took 113 (f32) and 88 (bf16) and ran GATE
// 20% slower (NVIDIA H100 80GB HBM3, 700 W; bench/ablate.py banded); with
// none it takes about 95 and 82 and spills nothing (chip_smoke.py's build
// phase checks).
constexpr int kMaxThreads = 192;
constexpr int kMaxCache = 32;     // cached edges per query row

__host__ __device__ __forceinline__ int query_rows(int nv) {
  return (frames_per_block(nv) + 2) * nv;
}
__host__ __device__ __forceinline__ int key_rows(int nv) {
  return (frames_per_block(nv) + 4) * nv;
}
__host__ __device__ __forceinline__ int block_threads(int nv) {
  return (query_rows(nv) + 31) / 32 * 32;
}

// Shared memory of one block, in bytes: q, dO (query rows) and k, v (key
// rows) in T; the band bits (6 x 32 words); (max, sum, D) of every query row
// and the cache, A and dP-then-dS by edge rank, both with a row stride of
// the block's threads.
template <typename T>
__host__ __device__ __forceinline__ int smem_bytes(int nv, int cap) {
  return (2 * query_rows(nv) + 2 * key_rows(nv)) * kDH * static_cast<int>(sizeof(T)) +
         6 * kMaxV * 4 + (3 + 2 * cap) * block_threads(nv) * 4;
}

// The staged tensors and the cache of one block.
template <typename T>
struct Block {
  const uint4* qs;   // query row s * nv + i: frame f0 - 1 + s
  const uint4* dos;
  const uint4* ks;   // key row s * nv + j: frame f0 - 2 + s
  const uint4* vs;
  const uint32_t* bits;
  float* stat;       // max, sum, D of query row r at r, stride + r, 2 stride + r
  float* ca;         // A of row r's edge of rank e at e * stride + r
  float* cd;         // dP, then dS
  int stride, cap, nv;
  float scale;

  // A and dS of the edge between query row r and key row kr, recomputed
  // from the row's statistics as the row phase computes them.
  __device__ __forceinline__ void recompute(int r, int kr, float& a, float& ds) const {
    a = expf(Staged<T>::dot(qs, r, ks, kr) * scale - stat[r]) / stat[stride + r];
    ds = a * (Staged<T>::dot(dos, r, vs, kr) - stat[2 * stride + r]);
  }
};

// The row phase for query row r (joint i of frame g, query slot sg).
template <typename T>
__device__ __forceinline__ void row_phase(const Block<T>& B, int r, int sg, int i, int g,
                                          int frames, bool own, T* __restrict__ dq_row) {
  const int nv = B.nv, stride = B.stride, cap = B.cap;
  // the row's edge bits of plane p, the clip's ends cut (no array: one
  // indexed by p could land in local memory where a loop stays rolled)
  const uint32_t b0 = g > 0 ? B.bits[i] : 0u, b1 = B.bits[kMaxV + i];
  const uint32_t b2 = g < frames - 1 ? B.bits[2 * kMaxV + i] : 0u;
  const auto b = [&](int p) { return p == 0 ? b0 : p == 1 ? b1 : b2; };
  const int kr0 = sg * nv;  // key row of joint 0 of frame g - 1; plane p at kr0 + p * nv
  float qr[kDH];
  Staged<T>::row(B.qs, r, qr);

  // the max of the scores, caching them
  float m = -INFINITY;
  int e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      const float s = Staged<T>::dot(qr, B.ks, kr0 + p * nv + __ffs(bb) - 1) * B.scale;
      m = fmaxf(m, s);
      if (e < cap) B.ca[e * stride + r] = s;
    }
  // the sum of exp(s - max), caching the terms
  float sum = 0.f;
  e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      float s;
      if (e < cap) {
        s = B.ca[e * stride + r];
      } else {
        s = Staged<T>::dot(qr, B.ks, kr0 + p * nv + __ffs(bb) - 1) * B.scale;
      }
      const float t = expf(s - m);
      sum += t;
      if (e < cap) B.ca[e * stride + r] = t;
    }
  // A, dP and D = sum A dP, caching A and dP
  float dor[kDH];
  Staged<T>::row(B.dos, r, dor);
  float dsum = 0.f;
  e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      const int kr = kr0 + p * nv + __ffs(bb) - 1;
      float t;
      if (e < cap) {
        t = B.ca[e * stride + r];
      } else {
        t = expf(Staged<T>::dot(qr, B.ks, kr) * B.scale - m);
      }
      const float a = t / sum;
      const float dp = Staged<T>::dot(dor, B.vs, kr);
      dsum += a * dp;
      if (e < cap) {
        B.ca[e * stride + r] = a;
        B.cd[e * stride + r] = dp;
      }
    }
  B.stat[r] = m;
  B.stat[stride + r] = sum;
  B.stat[2 * stride + r] = dsum;

  // dS into the cache; dQ of the block's own rows
  float self[kDH] = {}, band[kDH] = {};
  e = 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {
      const int kr = kr0 + p * nv + __ffs(bb) - 1;
      float ds;
      if (e < cap) {
        ds = B.ca[e * stride + r] * (B.cd[e * stride + r] - dsum);
        B.cd[e * stride + r] = ds;
      } else if (own) {
        float a;
        B.recompute(r, kr, a, ds);
      } else {
        continue;
      }
      if (!own) continue;
      if (p == 1) Staged<T>::axpy(round_to<T>(ds), B.ks, kr, self);
      else Staged<T>::axpy(ds, B.ks, kr, band);
    }
  if (!own) return;
#pragma unroll
  for (int d = 0; d < kDH; ++d) self[d] = self[d] * B.scale + B.scale * band[d];
  store_row(dq_row, self);
}

// dK (kDV false) or dV (true) of key joint j of own frame slot lf (frame f).
template <typename T, bool kDV>
__device__ __forceinline__ void column(const Block<T>& B, int lf, int j, int f, int frames,
                                       float (&out)[kDH]) {
  const int nv = B.nv;
  const int kr = (lf + 2) * nv + j;
  const uint32_t below = (1u << j) - 1u;
  float self[kDH] = {}, band[kDH] = {};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int g = f + 1 - p;  // the query frame that reaches frame f through plane p
    if (g < 0 || g >= frames) continue;
    const int r0 = (lf + 2 - p) * nv;
    for (uint32_t bb = B.bits[(3 + p) * kMaxV + j]; bb; bb &= bb - 1) {
      const int i = __ffs(bb) - 1;
      const int r = r0 + i;
      // the edge's rank in row r: its earlier planes, then its lower joints
      int e = __popc(B.bits[p * kMaxV + i] & below);
      if (p > 0 && g > 0) e += __popc(B.bits[i]);
      if (p == 2) e += __popc(B.bits[kMaxV + i]);
      float a, ds;
      if (e < B.cap) {
        a = B.ca[e * B.stride + r];
        ds = B.cd[e * B.stride + r];
      } else {
        B.recompute(r, kr, a, ds);
      }
      const float w = kDV ? a : ds;
      if (p == 1) Staged<T>::axpy(round_to<T>(w), kDV ? B.dos : B.qs, r, self);
      else Staged<T>::axpy(w, kDV ? B.dos : B.qs, r, band);
    }
  }
#pragma unroll
  for (int d = 0; d < kDH; ++d)
    out[d] = kDV ? self[d] + band[d] : self[d] * B.scale + B.scale * band[d];
}

template <typename T>
__global__ void  // no __launch_bounds__: with one, ptxas spilled the bf16 build (see below)
banded_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const uint32_t* __restrict__ rows, int frames, int nv, int cap,
                            float scale) {
  extern __shared__ __align__(16) uint4 smem[];
  using S = Staged<T>;
  const int fb = frames_per_block(nv);
  const int qrows = query_rows(nv), krows = key_rows(nv);
  uint4* qs = smem;
  uint4* dos = qs + qrows * S::kChunks;
  uint4* ks = dos + qrows * S::kChunks;
  uint4* vs = ks + krows * S::kChunks;
  uint32_t* bits = reinterpret_cast<uint32_t*>(vs + krows * S::kChunks);
  float* stat = reinterpret_cast<float*>(bits + 6 * kMaxV);
  const int stride = blockDim.x;
  const Block<T> B{qs, dos, ks, vs, bits, stat, stat + 3 * stride, stat + (3 + cap) * stride,
                   stride, cap, nv, scale};

  const int blocks_per_plane = (frames + fb - 1) / fb;
  const long long plane = blockIdx.x / blocks_per_plane;
  const int f0 = static_cast<int>(blockIdx.x % blocks_per_plane) * fb;
  const long long base = plane * frames * nv * kDH;

  S::stage(q + base, f0 - 1, f0 + fb, frames, nv, qs);
  S::stage(dout + base, f0 - 1, f0 + fb, frames, nv, dos);
  S::stage(k + base, f0 - 2, f0 + fb + 1, frames, nv, ks);
  S::stage(v + base, f0 - 2, f0 + fb + 1, frames, nv, vs);
  for (int t = threadIdx.x; t < 6 * kMaxV; t += blockDim.x) bits[t] = __ldg(rows + t);
  cp_async_wait_all();
  __syncthreads();

  {
    const int r = threadIdx.x;
    const int sg = r / nv;
    const int i = r - sg * nv;
    const int g = f0 - 1 + sg;
    if (r < qrows && g >= 0 && g < frames)
      row_phase<T>(B, r, sg, i, g, frames, sg >= 1 && sg <= fb,
                   dq + base + (static_cast<long long>(g) * nv + i) * kDH);
  }
  __syncthreads();

  const int lf = threadIdx.x / nv;
  const int j = threadIdx.x - lf * nv;
  const int f = f0 + lf;
  if (lf >= fb || f >= frames) return;
  const long long row = base + (static_cast<long long>(f) * nv + j) * kDH;
  float out[kDH];
  column<T, false>(B, lf, j, f, frames, out);
  store_row(dk + row, out);
  column<T, true>(B, lf, j, f, frames, out);
  store_row(dv + row, out);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv; const uint32_t* rows;
  long long planes; int frames; int nv; int cap; float scale; cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  const int fb = frames_per_block(a.nv);
  const long long blocks = a.planes * ((a.frames + fb - 1) / fb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int bytes = smem_bytes<T>(a.nv, a.cap);
  cudaError_t err = cudaFuncSetAttribute(banded_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  banded_attention_bwd_kernel<T><<<static_cast<unsigned>(blocks), block_threads(a.nv), bytes,
                                   a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.rows, a.frames, a.nv, a.cap, a.scale);
  return cudaGetLastError();
}

int cache_edges(int edges_per_row) {
  return edges_per_row < kMaxCache ? edges_per_row : kMaxCache;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv share it.
// `rows` as for banded_attention_fwd; `edges_per_row`: the most edges a
// query row of the band has (1 .. 3 * joints), which sizes the edge cache.
// Returns a cudaError_t (0 = launched).
extern "C" int banded_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, void* dq, void* dk, void* dv,
                                    const void* rows, long long planes, int frames,
                                    int joints, int dh, int dtype, int edges_per_row,
                                    float scale, void* stream) {
  if (planes <= 0 || frames <= 0 || joints <= 0 || joints > kMaxV || dh != kDH ||
      edges_per_row < 1 || edges_per_row > 3 * joints)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, static_cast<const uint32_t*>(rows), planes, frames,
               joints, cache_edges(edges_per_row), scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch<float>(a);
  else if (dtype == 1) err = launch<__nv_bfloat16>(a);
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) and threads of one block of
// banded_attention_bwd for these arguments. Returns a cudaError_t.
extern "C" int banded_attention_bwd_block(int joints, int dtype, int edges_per_row,
                                          int* smem, int* threads) {
  if (joints <= 0 || joints > kMaxV || edges_per_row < 1 || edges_per_row > 3 * joints ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = cache_edges(edges_per_row);
  *smem = dtype == 0 ? smem_bytes<float>(joints, cap) : smem_bytes<__nv_bfloat16>(joints, cap);
  *threads = block_threads(joints);
  return 0;
}
