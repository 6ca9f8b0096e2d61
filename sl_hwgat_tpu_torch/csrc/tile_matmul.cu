// Per-tile products of the kernel bench, for Hopper (sm_90a).
//
// Replaces the matrix-product probes of bench_kernel.py: mm_* (the
// pallas_call at :381), floor_dot1slim / floor_bigm / floor_sn256 (:450),
// tlay_mm (:515), mix_mm (:593), tmx_mm (:685), tmq_mm / tmq_bmm (:805) and
// matmul_only / matmul_k128 / matmul_only_bf16 (:1248), and the banded
// kernel's product-only probe K10 (sl_hwgat_tpu/ops/pallas_banded.py:395,
// _fwd_kernel_packed_mm). For every tile t of M rows:
//
//   S_t = X_t . Y_t^T         (M x M, depth K, f32 sums)
//   mode 0: O_t = round(S_t) . Z_t   (S rounded to the input type, f32 sums,
//                                     M x C, stored in the output type)
//   mode 1: O_t = S_t[:, :C]          (the f32 sums stored in the output type)
//
// Each operand is a base pointer with a (plane, tile, row, column) stride,
// so every probe layout is a view: row-major (T, SN, DH), transposed
// (T, DH, SN), the model-wide (H, DH, TH*SN) planes, K10's (P, F*V, dh)
// banded planes (a tile is 128/Vp frames: 116 tokens for 29 joints, 128
// for 16), and floor_bigm's shared Y (tile stride 0 within a group).
//
// Bound on an H100 SXM: operations in f32 (the bench's 3072 tiles of
// 128 x 64: 12.9 GFLOP, 192 us at 67 TFLOP/s), bytes for bf16 inputs (one
// read of X and one f32 write of O, 45 us). This first design is simple:
// one block of 256 threads per 64-row slice of a tile, Y (then Z) and the
// slice of X and S staged in shared memory as f32 (rows padded by one word:
// no bank conflicts), 4 x 4 outputs a thread as f32 FMAs on the CUDA cores,
// which holds the f32 bars in both types. The output goes through shared
// memory too, so a transposed store writes whole runs. Tensor-core
// products (mma.sync / wgmma) are later work.

#include "probe_common.cuh"

namespace {

using probe::from_float;
using probe::round_to;
using probe::to_float;

constexpr int kThreads = 256;
constexpr int kSlice = 64;  // rows of a tile per block
constexpr int kMaxRows = 256, kMaxDepth = 128, kMaxCols = 128;

struct Strides {
  long long v[16];  // x, y, z, o: (plane, tile, row, column) each
};

__device__ __forceinline__ long long tile_base(const Strides& s, int op, long long plane,
                                               long long tile) {
  return plane * s.v[4 * op] + tile * s.v[4 * op + 1];
}

// rows x cols of an operand (element (i, c) at base + i*rs + c*cs) into
// shared memory with row stride ld, as f32; the faster-varying index follows
// the unit stride, so global reads coalesce in either layout.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ g, long long rs, long long cs,
                                      int rows, int cols, float* sh, int ld) {
  const int n = rows * cols;
  if (cs == 1) {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int i = e / cols, c = e % cols;
      sh[i * ld + c] = to_float(g[i * rs + c]);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int c = e / rows, i = e % rows;
      sh[i * ld + c] = to_float(g[i * rs + c * cs]);
    }
  }
}

template <typename TO>
__device__ __forceinline__ void unstage(const float* sh, int ld, int rows, int cols,
                                        TO* __restrict__ g, long long rs, long long cs) {
  const int n = rows * cols;
  if (cs == 1) {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int i = e / cols, c = e % cols;
      g[i * rs + c] = from_float<TO>(sh[i * ld + c]);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int c = e / rows, i = e % rows;
      g[i * rs + c * cs] = from_float<TO>(sh[i * ld + c]);
    }
  }
}

// acc[a][b] = sum_k A[ty + 16a][k] * B[col0 + tx + 16b][k], both in shared
// memory with row strides lda, ldb (B rows >= nb clamped; the caller drops
// them).
__device__ __forceinline__ void product_nt(const float* A, int lda, const float* B, int ldb,
                                           int depth, int col0, int nb, float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  int col[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) col[b] = min(col0 + tx + 16 * b, nb - 1);
  for (int k = 0; k < depth; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * lda + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[col[b] * ldb + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// acc[a][b] = sum_j A[ty + 16a][j] * B[j][col0 + tx + 16b] for b < kB (the
// 16-column groups the output has: K10's 16 columns take one), columns >= nb
// clamped; the caller drops them.
template <int kB>
__device__ __forceinline__ void product_nn(const float* A, int lda, const float* B, int ldb,
                                           int depth, int col0, int nb, float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  int col[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) col[b] = min(col0 + tx + 16 * b, nb - 1);
  for (int j = 0; j < depth; ++j) {
    float av[4], bv[kB];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * lda + j];
#pragma unroll
    for (int b = 0; b < kB; ++b) bv[b] = B[j * ldb + col[b]];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// product_nn over the 64 columns from col0, with as many 16-column groups as
// the output has there.
__device__ __forceinline__ void product_nn_cols(const float* A, int lda, const float* B, int ldb,
                                                int depth, int col0, int nb,
                                                float (&acc)[4][4]) {
  const int width = nb - col0;
  if (width > 48) product_nn<4>(A, lda, B, ldb, depth, col0, nb, acc);
  else if (width > 32) product_nn<3>(A, lda, B, ldb, depth, col0, nb, acc);
  else if (width > 16) product_nn<2>(A, lda, B, ldb, depth, col0, nb, acc);
  else product_nn<1>(A, lda, B, ldb, depth, col0, nb, acc);
}

struct Dims {
  long long tiles;  // tiles per plane
  int rows, depth, cols, mode;
};

// Shared memory (floats): X slice [64][K+1], Y then Z [M][max(K, C)+1],
// S slice [64][Ms+1] (Ms = M in mode 0, C in mode 1), reused for O.
__host__ __device__ inline int smem_floats(const Dims& d) {
  const int ms = d.mode == 0 ? d.rows : d.cols;
  const int wide = d.mode == 0 ? (d.depth > d.cols ? d.depth : d.cols) : d.depth;
  return kSlice * (d.depth + 1) + d.rows * (wide + 1) + kSlice * (ms + 1);
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ z,
                   TO* __restrict__ o, Strides s, Dims d) {
  extern __shared__ float sh[];
  const int m = d.rows, k = d.depth, c = d.cols;
  const int ms = d.mode == 0 ? m : c;  // S columns needed
  const int ldx = k + 1, ldy = k + 1, ldz = c + 1, lds = ms + 1;
  float* xs = sh;
  float* yz = xs + kSlice * ldx;
  float* ss = yz + m * ((d.mode == 0 ? max(k, c) : k) + 1);

  const long long plane = blockIdx.x / d.tiles, tile = blockIdx.x % d.tiles;
  const int r0 = blockIdx.y * kSlice;
  const int rows = min(kSlice, m - r0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // X slice and the Y rows S needs; slice rows past the tile's end are 0
  for (int e = threadIdx.x; e < (kSlice - rows) * ldx; e += kThreads)
    xs[rows * ldx + e] = 0.f;
  stage(x + tile_base(s, 0, plane, tile) + r0 * s.v[2], s.v[2], s.v[3], rows, k, xs, ldx);
  stage(y + tile_base(s, 1, plane, tile), s.v[6], s.v[7], ms, k, yz, ldy);
  __syncthreads();

  for (int col0 = 0; col0 < ms; col0 += 64) {
    float acc[4][4];
    product_nt(xs, ldx, yz, ldy, k, col0, ms, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = col0 + tx + 16 * b;
        if (j < ms) ss[(ty + 16 * a) * lds + j] = d.mode == 0 ? round_to<T>(acc[a][b]) : acc[a][b];
      }
  }
  __syncthreads();

  TO* ob = o + tile_base(s, 3, plane, tile) + r0 * s.v[14];
  if (d.mode == 1) {
    unstage(ss, lds, rows, c, ob, s.v[14], s.v[15]);
    return;
  }

  stage(z + tile_base(s, 2, plane, tile), s.v[10], s.v[11], m, c, yz, ldz);
  __syncthreads();
  float lo[4][4], hi[4][4];  // output columns 0-63 and 64-127 (c <= 128)
  product_nn_cols(ss, lds, yz, ldz, m, 0, c, lo);
  if (c > 64) product_nn_cols(ss, lds, yz, ldz, m, 64, c, hi);
  __syncthreads();  // every thread is done with S: its rows take O
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      if (j < c) ss[(ty + 16 * a) * ldz + j] = lo[a][b];
      if (c > 64 && j + 64 < c) ss[(ty + 16 * a) * ldz + j + 64] = hi[a][b];
    }
  __syncthreads();
  unstage(ss, ldz, rows, c, ob, s.v[14], s.v[15]);
}

template <typename T, typename TO>
cudaError_t launch(const void* x, const void* y, const void* z, void* o, const Strides& s,
                   long long planes, const Dims& d, cudaStream_t stream) {
  const int bytes = smem_floats(d) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(tile_matmul_kernel<T, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(planes * d.tiles), (d.rows + kSlice - 1) / kSlice);
  tile_matmul_kernel<T, TO><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<TO*>(o), s, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(const void* x, const void* y, const void* z, void* o, const Strides& s,
                       long long planes, const Dims& d, int out_dtype, cudaStream_t stream) {
  if (out_dtype == 0) return launch<T, float>(x, y, z, o, s, planes, d, stream);
  if (out_dtype == 1) return launch<T, __nv_bfloat16>(x, y, z, o, s, planes, d, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: (planes, tiles, rows, depth) views, z: (planes, tiles, rows, cols)
// (mode 0; unused in mode 1), o: (planes, tiles, rows, cols), each given by
// its base pointer and 4 strides in `strides` (host memory, 16 int64:
// x, y, z, o). rows <= 256, depth <= 128, cols <= 128 and (mode 0) cols <=
// rows, (mode 1) cols <= rows. Types: 0 = float32, 1 = bfloat16 (x, y, z
// share in_dtype). Returns a cudaError_t (0 = launched).
extern "C" int tile_matmul(const void* x, const void* y, const void* z, void* o,
                           const void* strides, long long planes, long long tiles, int rows,
                           int depth, int cols, int mode, int in_dtype, int out_dtype,
                           void* stream) {
  if (planes <= 0 || tiles <= 0 || planes * tiles > 0x7fffffffLL || rows < 1 ||
      rows > kMaxRows || depth < 1 || depth > kMaxDepth || cols < 1 || cols > kMaxCols ||
      cols > rows || (mode != 0 && mode != 1) || (mode == 0 && z == nullptr) ||
      strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s;
  for (int i = 0; i < 16; ++i) s.v[i] = static_cast<const long long*>(strides)[i];
  const Dims d{tiles, rows, depth, cols, mode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return static_cast<int>(launch_out<float>(x, y, z, o, s, planes, d, out_dtype, st));
  if (in_dtype == 1)
    return static_cast<int>(launch_out<__nv_bfloat16>(x, y, z, o, s, planes, d, out_dtype, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
