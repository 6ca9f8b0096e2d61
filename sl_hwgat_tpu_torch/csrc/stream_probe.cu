// Stream probes of the kernel bench, for Hopper (sm_90a).
//
// Replaces the zero-compute probes of bench_kernel.py that stream tensors
// through the TPU: floor_copy / floor_slab / floor_pure* (the pallas_call at
// :450), tlay_copy (:515), mix_floor (:593), tmx_floor (:685), tmq_floor
// (:805), tsw_floor (:951), dmaflr_hbm / dmaflr_3stream / dmaflr_qkvpack
// (:1045, :1066, :1090) and xstrided_ref (:1181). Few functions hide behind
// their layouts; this kernel computes them on flat element streams:
//
//   mode 0, copy:   o = x, converted from in_dtype to out_dtype
//   mode 1, sum3:   o = x + 0*y + 0*a, all in_dtype (out_dtype == in_dtype)
//   mode 2, floor:  o = (x [+ y]) * (sum_g a [+ sum_g b]), where x + y is
//                   rounded to in_dtype (the probes add in their stream type)
//                   and sum_g runs in f32 over the group g of the element.
//
// Groups: every tensor is viewed as (outer, rows, cols), and a group is one
// outer index times a run of `group_cols` columns over all rows: a (SN, DH)
// tile of the mix/tmx/tmq probes is (outer = tile, rows = 1, cols = 8192),
// a tsw_floor block is (outer = head, rows = DH, cols = TH*SN) in runs of
// TG*SN. The sums of a tile do not depend on its layout, so x and a may lie
// in different layouts of the same tile.
//
// Bound on an H100 SXM: bytes. Every input is read once and the output
// written once: 100.7 MB for a bf16 copy of 12288 x 32 x 64 (30 us at
// 3.35 TB/s), 151 MB bf16 -> f32, 201 MB for three bf16 streams in. The
// design reads and writes 16 bytes a thread, one vector per thread (modes
// 0, 1); mode 2 runs one block per group, which sums its a and b with
// 16-byte loads and a block reduction, then streams x, y and o, so every
// byte moves once. The TPU probe dmaflr_hbm (an HBM-to-HBM DMA) is mode 0
// here; a TMA bulk-copy variant is later work.

#include <type_traits>

#include "probe_common.cuh"

namespace {

using probe::from_float;
using probe::load8;
using probe::round_to;
using probe::store8;
using probe::to_float;

constexpr int kThreads = 256;

__device__ __forceinline__ long long thread_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long thread_count() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const TI* __restrict__ x, TO* __restrict__ o, long long n) {
  const long long vecs = n / 8;
  for (long long i = thread_index(); i < vecs; i += thread_count()) {
    float v[8];
    load8(x + 8 * i, v);
    store8(o + 8 * i, v);
  }
  for (long long i = vecs * 8 + thread_index(); i < n; i += thread_count())
    o[i] = from_float<TO>(to_float(x[i]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum3_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ z,
            T* __restrict__ o, long long n) {
  const long long vecs = n / 8;
  for (long long i = thread_index(); i < vecs; i += thread_count()) {
    float a[8], b[8], c[8];
    load8(x + 8 * i, a);
    load8(y + 8 * i, b);
    load8(z + 8 * i, c);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = a[e] + b[e] * 0.f + c[e] * 0.f;
    store8(o + 8 * i, a);
  }
  for (long long i = vecs * 8 + thread_index(); i < n; i += thread_count())
    o[i] = from_float<T>(to_float(x[i]) + to_float(y[i]) * 0.f + to_float(z[i]) * 0.f);
}

__device__ __forceinline__ float block_sum(float v, float* shared) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += shared[w];
  __syncthreads();
  return total;
}

// One block per group: (outer index, run of group_cols columns).
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
floor_kernel(const TI* __restrict__ x, const TI* __restrict__ y, const TI* __restrict__ a,
             const TI* __restrict__ b, TO* __restrict__ o, long long rows, long long cols,
             long long group_cols) {
  __shared__ float partial[kThreads / 32];
  const long long runs = cols / group_cols;
  const long long outer = blockIdx.x / runs, run = blockIdx.x % runs;
  const long long base = outer * rows * cols + run * group_cols;
  const long long vecs_per_row = group_cols / 8, vecs = rows * vecs_per_row;
  auto offset = [&](long long v) {
    return base + (v / vecs_per_row) * cols + (v % vecs_per_row) * 8;
  };

  float sa = 0.f, sb = 0.f;
  for (long long v = threadIdx.x; v < vecs; v += kThreads) {
    const long long off = offset(v);
    float e[8];
    load8(a + off, e);
#pragma unroll
    for (int i = 0; i < 8; ++i) sa += e[i];
    if (b != nullptr) {
      load8(b + off, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) sb += e[i];
    }
  }
  const float scale = block_sum(sa, partial) + (b != nullptr ? block_sum(sb, partial) : 0.f);

  for (long long v = threadIdx.x; v < vecs; v += kThreads) {
    const long long off = offset(v);
    float e[8];
    load8(x + off, e);
    if (y != nullptr) {
      float f[8];
      load8(y + off, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = round_to<TI>(e[i] + f[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] *= scale;
    store8(o + off, e);
  }
}

// One 8-element vector a thread where the grid allows (the loops stride on
// past that).
unsigned stream_blocks(long long n) {
  const long long want = (n / 8 + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 1 ? 1 : (want > (1LL << 30) ? (1LL << 30) : want));
}

struct Args {
  int mode; const void* x; const void* y; const void* a; const void* b; void* o;
  long long outer, rows, cols, group_cols; cudaStream_t stream;
};

template <typename TI, typename TO>
cudaError_t launch(const Args& g) {
  const long long n = g.outer * g.rows * g.cols;
  const TI* x = static_cast<const TI*>(g.x);
  TO* o = static_cast<TO*>(g.o);
  if (g.mode == 0) {
    copy_kernel<TI, TO><<<stream_blocks(n), kThreads, 0, g.stream>>>(x, o, n);
  } else if (g.mode == 1) {
    if constexpr (std::is_same<TI, TO>::value)
      sum3_kernel<TI><<<stream_blocks(n), kThreads, 0, g.stream>>>(
          x, static_cast<const TI*>(g.y), static_cast<const TI*>(g.a), o, n);
    else
      return cudaErrorInvalidValue;
  } else {
    const long long groups = g.outer * (g.cols / g.group_cols);
    if (groups > 0x7fffffffLL) return cudaErrorInvalidValue;
    floor_kernel<TI, TO><<<static_cast<unsigned>(groups), kThreads, 0, g.stream>>>(
        x, static_cast<const TI*>(g.y), static_cast<const TI*>(g.a),
        static_cast<const TI*>(g.b), o, g.rows, g.cols, g.group_cols);
  }
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_out(const Args& g, int out_dtype) {
  if (out_dtype == 0) return launch<TI, float>(g);
  if (out_dtype == 1) return launch<TI, __nv_bfloat16>(g);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode 0 copy, 1 sum3, 2 floor (see above). Every tensor is contiguous,
// 16-byte aligned and holds outer * rows * cols elements; y and b may be
// null in mode 2 (a may not); mode 2 needs group_cols to divide cols and be
// a multiple of 8. Types: 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int stream_probe(int mode, const void* x, const void* y, const void* a,
                            const void* b, void* o, long long outer, long long rows,
                            long long cols, long long group_cols, int in_dtype, int out_dtype,
                            void* stream) {
  const long long n = outer * rows * cols;
  if (n <= 0 || mode < 0 || mode > 2 || x == nullptr || o == nullptr ||
      (mode == 1 && (y == nullptr || a == nullptr || in_dtype != out_dtype)) ||
      (mode == 2 && (a == nullptr || group_cols <= 0 || group_cols % 8 || cols % group_cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{mode, x, y, a, b, o, outer, rows, cols, group_cols,
               static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0) return static_cast<int>(launch_out<float>(g, out_dtype));
  if (in_dtype == 1) return static_cast<int>(launch_out<__nv_bfloat16>(g, out_dtype));
  return static_cast<int>(cudaErrorInvalidValue);
}
