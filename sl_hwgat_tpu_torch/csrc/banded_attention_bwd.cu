// Banded (block-tridiagonal) graph attention, backward, for Hopper (sm_90a).
//
// Replaces sl_hwgat_tpu/ops/pallas_banded.py::_bwd_kernel_packed (K8) and
// ::_bwd_kernel (K9) on the token-major (P, F * V, 16) layout, T = f32 or
// bf16 (q's type), dO already in T. With A recomputed by the forward's code
// (banded_attention_common.cuh) and over the band's edges only:
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
// 128 / V frames of one plane and stages q, dO of its frames +-1 and k, v of
// its frames +-2 in shared memory (f32, dynamic, up to 60 KB). Then:
//   row phase: one thread per staged query row computes its softmax
//     statistics and D into shared memory, and dQ for the block's own rows;
//   column phase: one thread per own key row gathers dK and dV over the
//     edges of its column (the band's transposed bits), recomputing A_ij and
//     dS_ij from the shared statistics, bit for bit those of the row phase.
// The statistics of the two boundary frames are computed by both blocks
// that need them: (128 / V + 2) / (128 / V) of the row work.
//
// Bound on an H100 SXM: bytes. A call reads q, k, v, dO and writes dq, dk,
// dv once: 7 * P * F * V * 16 elements, 705 MB in f32 at WGATE's shape
// (0.210 ms at 3.35 TB/s), against about 1.2 GFLOP of edge products.

#include "banded_attention_common.cuh"

namespace {

using namespace battn;

__host__ __device__ __forceinline__ int query_slots(int nv) { return frames_per_block(nv) + 2; }
__host__ __device__ __forceinline__ int key_slots(int nv) { return frames_per_block(nv) + 4; }

// Floats of shared memory: q, dO (query slots), k, v (key slots), and
// (max, sum, D) per staged query row.
__host__ __device__ __forceinline__ int smem_floats(int nv) {
  return (2 * query_slots(nv) + 2 * key_slots(nv)) * nv * kDH + 3 * query_slots(nv) * nv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const uint32_t* __restrict__ rows, int frames, int nv,
                            float scale) {
  extern __shared__ __align__(16) float smem[];
  const int fb = frames_per_block(nv);
  const int qrows = query_slots(nv) * nv;
  const int krows = key_slots(nv) * nv;
  float* qs = smem;                // query slot s: frame f0 - 1 + s
  float* dos = qs + qrows * kDH;
  float* ks = dos + qrows * kDH;   // key slot s: frame f0 - 2 + s
  float* vs = ks + krows * kDH;
  float* stat = vs + krows * kDH;  // (max, sum, D) of query row r at 3 r

  const int blocks_per_plane = (frames + fb - 1) / fb;
  const long long plane = blockIdx.x / blocks_per_plane;
  const int f0 = static_cast<int>(blockIdx.x % blocks_per_plane) * fb;
  const long long base = plane * frames * nv * kDH;

  stage_frames<T>(q + base, f0 - 1, f0 + fb, frames, nv, qs);
  stage_frames<T>(dout + base, f0 - 1, f0 + fb, frames, nv, dos);
  stage_frames<T>(k + base, f0 - 2, f0 + fb + 1, frames, nv, ks);
  stage_frames<T>(v + base, f0 - 2, f0 + fb + 1, frames, nv, vs);
  __syncthreads();

  // Row phase.
  for (int r = threadIdx.x; r < qrows; r += blockDim.x) {
    const int sg = r / nv;
    const int i = r % nv;
    const int g = f0 - 1 + sg;
    if (g < 0 || g >= frames) continue;
    float qr[kDH], dor[kDH];
    copy_row(qs + r * kDH, qr);
    copy_row(dos + r * kDH, dor);
    const RowBits b = row_bits(rows, i, g, frames);
    const float* keys = ks + sg * nv * kDH;  // frame g - 1; plane p is slot sg + p
    const float* vals = vs + sg * nv * kDH;
    const RowStats st = row_stats(qr, keys, b, nv, scale);
    float dsum = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      for (uint32_t bits = b.p[p]; bits; bits &= bits - 1) {
        const int e = (p * nv + __ffs(bits) - 1) * kDH;
        dsum += prob(dot(qr, keys + e) * scale, st) * dot(dor, vals + e);
      }
    stat[3 * r] = st.max;
    stat[3 * r + 1] = st.sum;
    stat[3 * r + 2] = dsum;
    if (sg < 1 || sg > fb) continue;  // a neighbour block's row: statistics only

    float self[kDH] = {}, band[kDH] = {};
#pragma unroll
    for (int p = 0; p < 3; ++p)
      for (uint32_t bits = b.p[p]; bits; bits &= bits - 1) {
        const int e = (p * nv + __ffs(bits) - 1) * kDH;
        const float a = prob(dot(qr, keys + e) * scale, st);
        const float ds = a * (dot(dor, vals + e) - dsum);
        if (p == 1) axpy(round_to<T>(ds), keys + e, self);
        else axpy(ds, keys + e, band);
      }
#pragma unroll
    for (int d = 0; d < kDH; ++d) self[d] = self[d] * scale + scale * band[d];
    store_row(dq + base + (static_cast<long long>(g) * nv + i) * kDH, self);
  }
  __syncthreads();

  // Column phase: key j of frame f.
  const int lf = threadIdx.x / nv;
  const int j = threadIdx.x % nv;
  const int f = f0 + lf;
  if (lf >= fb || f >= frames) return;
  float kr[kDH], vr[kDH];
  copy_row(ks + ((lf + 2) * nv + j) * kDH, kr);
  copy_row(vs + ((lf + 2) * nv + j) * kDH, vr);
  float dks[kDH] = {}, dkb[kDH] = {}, dvs[kDH] = {}, dvb[kDH] = {};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int g = f + 1 - p;  // the query frame that reaches frame f through plane p
    if (g < 0 || g >= frames) continue;
    const int r0 = (lf + 2 - p) * nv;
    for (uint32_t bits = __ldg(rows + (3 + p) * kMaxV + j); bits; bits &= bits - 1) {
      const int r = r0 + __ffs(bits) - 1;
      const float* qi = qs + r * kDH;
      const float* doi = dos + r * kDH;
      const RowStats st{stat[3 * r], stat[3 * r + 1]};
      const float a = prob(dot(kr, qi) * scale, st);
      const float ds = a * (dot(vr, doi) - stat[3 * r + 2]);
      if (p == 1) {
        axpy(round_to<T>(ds), qi, dks);
        axpy(round_to<T>(a), doi, dvs);
      } else {
        axpy(ds, qi, dkb);
        axpy(a, doi, dvb);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kDH; ++d) {
    dks[d] = dks[d] * scale + scale * dkb[d];
    dvs[d] += dvb[d];
  }
  const long long row = base + (static_cast<long long>(f) * nv + j) * kDH;
  store_row(dk + row, dks);
  store_row(dv + row, dvs);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  void* dq; void* dk; void* dv; const uint32_t* rows;
  long long planes; int frames; int nv; float scale; cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  const int fb = frames_per_block(a.nv);
  const long long blocks = a.planes * ((a.frames + fb - 1) / fb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int bytes = smem_floats(a.nv) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(banded_attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  banded_attention_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.rows, a.frames, a.nv, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v, dout, dq, dk, dv share it.
// `rows` as for banded_attention_fwd. Returns a cudaError_t (0 = launched).
extern "C" int banded_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* dout, void* dq, void* dk, void* dv,
                                    const void* rows, long long planes, int frames,
                                    int joints, int dh, int dtype, float scale, void* stream) {
  if (planes <= 0 || frames <= 0 || joints <= 0 || joints > kMaxV || dh != kDH)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, dq, dk, dv, static_cast<const uint32_t*>(rows), planes, frames,
               joints, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch<float>(a);
  else if (dtype == 1) err = launch<__nv_bfloat16>(a);
  return static_cast<int>(err);
}
