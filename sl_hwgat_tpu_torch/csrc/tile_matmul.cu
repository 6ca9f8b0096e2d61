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
// 128 x 64: 12.9 GFLOP, 192 us at 67 TFLOP/s; K10 at WGATE the same),
// bytes for bf16 inputs (one read of X, Y, Z and one write of O: 45-75 us).
//
// bf16 inputs (tile_mma_kernel): one block per tile, a warp per 16-row
// strip (8 warps at 128 rows, 16 at 256). X, Y and Z
// are staged in shared memory in bf16 (16-byte cp.async where a row is a
// run of aligned 16-byte chunks, element by element along the unit stride
// otherwise), rows padded by 16 bytes so that ldmatrix meets no bank
// conflicts; rows past the tile's end and columns past the depth are zeros,
// with no weight in either product. S runs on mma.sync m16n8k16 with f32
// sums, 64 columns at a time;
// in mode 0 each chunk of S is rounded to bf16 in registers and fed back as
// the A operand of O += S_chunk Z_chunk (Z by ldmatrix.trans), so S never
// passes through shared memory (the register reuse of FlashAttention-2).
// Outputs of more than 64 columns take two passes. The output goes through
// shared memory as f32 and out along its unit stride, in 16-byte chunks
// where it can. K10's tiles (16 columns, depth 16) keep the block's warps
// on their rows: nothing is spent on output columns a tile does not have.
//
// f32 inputs (tile_simt_kernel): exact f32 FMAs on the CUDA cores (TF32
// sums would miss the 1e-5 bar). One block of 256 threads per 128-row slice
// of a tile; X and 64-row chunks of Y staged transposed (depth-major), so
// that a thread's 8 rows and 4 columns of S are three 16-byte loads a
// depth step (32 FMAs); each S chunk is written transposed to shared memory
// and O += S_chunk Z_chunk runs in 8 x C/16 register tiles. Every sum runs
// over its index ascending from 0 by fused multiply-adds, as the
// one-thread-per-4x4 design before it summed, so the output is that
// design's bit for bit.

#include "probe_common.cuh"

namespace {

using probe::from_float;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxRows = 256, kMaxDepth = 128, kMaxCols = 128;
constexpr int kChunk = 64;  // S columns a pass
constexpr int kSlice = 128;  // f32: rows of a tile per block

struct Strides {
  long long v[16];  // x, y, z, o: (plane, tile, row, column) each
};

// Operand flags: bit op (x 0, y 1, z 2, o 3) where its rows are runs of
// aligned 16-byte chunks (column stride 1); bit 4 + op where its columns are
// (row stride 1).
constexpr int kColsVec = 4;

struct Dims {
  long long tiles;  // tiles per plane
  int rows, depth, cols, mode, vec;
};

__device__ __forceinline__ long long tile_base(const Strides& s, int op, long long plane,
                                               long long tile) {
  return plane * s.v[4 * op] + tile * s.v[4 * op + 1];
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---- PTX -------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// The rows x cols elements (i, c) at g + i rs + c cs into a shared tile of
// prow x pcol elements of T, rows ld apart, zeros past rows x cols. With
// `vec` (cs == 1, aligned rows, cols a multiple of 16 / sizeof(T)) by
// 16-byte cp.async, else element by element, lanes along the unit stride.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ g, long long rs, long long cs, int rows,
                                      int cols, int prow, int pcol, T* sh, int ld, bool vec) {
  constexpr int kEpc = 16 / sizeof(T);
  const int nt = blockDim.x;
  if (vec) {
    const int cpr = pcol / kEpc;
    for (int e = threadIdx.x; e < prow * cpr; e += nt) {
      const int i = e / cpr, c = e % cpr * kEpc;
      T* d = sh + i * ld + c;
      if (i < rows && c < cols) cp_async16(d, g + i * rs + c);
      else zero16(d);
    }
  } else if (cs == 1) {
    for (int e = threadIdx.x; e < prow * pcol; e += nt) {
      const int i = e / pcol, c = e % pcol;
      sh[i * ld + c] = i < rows && c < cols ? g[i * rs + c] : from_float<T>(0.f);
    }
  } else {
    for (int e = threadIdx.x; e < prow * pcol; e += nt) {
      const int c = e / prow, i = e % prow;
      sh[i * ld + c] = i < rows && c < cols ? g[i * rs + c * cs] : from_float<T>(0.f);
    }
  }
}

// f32 rows x depth elements (i, k) at g + i rs + k cs, transposed into a
// shared tile sh[k][i] of prow columns (rows prow apart), zeros past rows.
// `rows_vec` (cs == 1, aligned rows, depth % 4 == 0): a lane loads 4 depths
// of its row, lanes along rows; `cols_vec` (rs == 1, aligned columns, rows %
// 4 == 0): a lane loads 4 rows of one depth and stores them whole.
__device__ __forceinline__ void stage_transposed(const float* __restrict__ g, long long rs,
                                                 long long cs, int rows, int depth, int prow,
                                                 float* sh, bool rows_vec, bool cols_vec) {
  if (rows_vec) {
    for (int e = threadIdx.x; e < prow * depth / 4; e += kThreads) {
      const int i = e % prow, k = e / prow * 4;
      const float4 x = i < rows ? __ldg(reinterpret_cast<const float4*>(g + i * rs + k))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      sh[k * prow + i] = x.x;
      sh[(k + 1) * prow + i] = x.y;
      sh[(k + 2) * prow + i] = x.z;
      sh[(k + 3) * prow + i] = x.w;
    }
  } else if (cols_vec) {
    for (int e = threadIdx.x; e < prow / 4 * depth; e += kThreads) {
      const int i = e % (prow / 4) * 4, k = e / (prow / 4);
      *reinterpret_cast<float4*>(sh + k * prow + i) =
          i < rows ? __ldg(reinterpret_cast<const float4*>(g + i + k * cs))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else if (cs == 1) {
    for (int e = threadIdx.x; e < prow * depth; e += kThreads) {
      const int i = e / depth, k = e % depth;
      sh[k * prow + i] = i < rows ? g[i * rs + k] : 0.f;
    }
  } else {
    for (int e = threadIdx.x; e < prow * depth; e += kThreads) {
      const int i = e % prow, k = e / prow;
      sh[k * prow + i] = i < rows ? g[i * rs + k * cs] : 0.f;
    }
  }
}

// The f32 output staged in shared memory (rows x cols, rows ld apart) into
// the output view, rounded to TO: 16-byte stores along rows where `vec`
// (cs == 1, aligned rows, cols a multiple of 16 / sizeof(TO)), else element
// by element, lanes along the unit stride.
__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store_chunk(bf16* p, const float* v) {
  const float4 a = *reinterpret_cast<const float4*>(v), b = *reinterpret_cast<const float4*>(v + 4);
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

template <typename TO>
__device__ __forceinline__ void unstage(const float* sh, int ld, int rows, int cols,
                                        TO* __restrict__ g, long long rs, long long cs, bool vec) {
  constexpr int kEpc = 16 / sizeof(TO);
  const int nt = blockDim.x;
  if (vec) {
    const int cpr = cols / kEpc;
    for (int e = threadIdx.x; e < rows * cpr; e += nt) {
      const int i = e / cpr, c = e % cpr * kEpc;
      store_chunk(g + i * rs + c, sh + i * ld + c);
    }
  } else if (cs == 1) {
    for (int e = threadIdx.x; e < rows * cols; e += nt) {
      const int i = e / cols, c = e % cols;
      g[i * rs + c] = from_float<TO>(sh[i * ld + c]);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += nt) {
      const int c = e / rows, i = e % rows;
      g[i * rs + c * cs] = from_float<TO>(sh[i * ld + c]);
    }
  }
}

// ---- bf16 inputs: tensor cores ---------------------------------------------

// Shared memory of the bf16 kernel: X (rows padded to 16), Y (to the
// 64-column chunks of S, or to the output's columns in mode 1), Z (mode 0),
// all bf16 with rows padded by 16 bytes, and the f32 output, over X and Y
// where one pass over the output's columns does (C <= 64), else beside them.
struct MmaLayout {
  int kp, ld, mx, ny, nz, zld, old, passes;
  __host__ __device__ MmaLayout(const Dims& d, int nt) {
    passes = d.cols > 8 * nt ? 2 : 1;
    kp = round_up(d.depth, 16);
    ld = kp + 8;
    mx = round_up(d.rows, 16);
    ny = d.mode == 0 ? round_up(d.rows, kChunk) : 8 * nt * passes;
    nz = d.mode == 0 ? ny : 0;
    zld = 8 * nt * passes + 8;
    old = 8 * nt * passes + 8;
  }
  __host__ __device__ int xy_bytes() const { return (mx + ny) * ld * 2; }
  __host__ __device__ int out_bytes() const { return mx * old * 4; }
  __host__ __device__ int out_offset() const { return passes == 1 ? 0 : xy_bytes(); }
  __host__ __device__ int z_offset() const {
    return passes == 1 ? (xy_bytes() > out_bytes() ? xy_bytes() : out_bytes())
                       : xy_bytes() + out_bytes();
  }
  __host__ __device__ int bytes() const { return z_offset() + nz * zld * 2; }
  __host__ __device__ int threads() const { return 2 * mx; }  // a warp per 16-row strip
};

// acc = X[r0 .. r0 + 15] Y[0 .. 8 kNT)^T over kp depths (a multiple of 16),
// on the m16n8 accumulator layout; rows ld elements apart.
template <int kNT>
__device__ __forceinline__ void strip_xyt(const bf16* xs, const bf16* ys, int ld, int r0, int kp,
                                          int lane, float (&acc)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int kk = 0; kk < kp; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, xs + (r0 + (lane & 15)) * ld + kk + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {  // Y rows 16jp .. 16jp + 15: tiles 2jp, 2jp + 1
      uint32_t b[4];
      ldsm_x4(b, ys + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * ld + kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc += P Z: P, 16 x 64 as the A operands of four k-steps, and 64 rows of
// Z (ld elements apart) read across rows by ldmatrix.trans.
template <int kNT>
__device__ __forceinline__ void strip_pz(const uint32_t (&p)[kChunk / 16][4], const bf16* zs,
                                         int ld, int lane, float (&acc)[kNT][4]) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, zs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + 16 * jp +
                           (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], p[kk], b[2], b[3]);
    }
}

// Rows r0 .. r0 + 15 of the accumulator layout into the f32 staging tile.
template <int kNT>
__device__ __forceinline__ void write_strip(float* os, int ld, const float (&x)[kNT][4], int r0,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<float2*>(os + (r0 + g + 8 * h) * ld + 8 * j + 2 * t) =
          make_float2(x[j][2 * h], x[j][2 * h + 1]);
}

// kNT: 8-column tiles of the output a pass (C <= 8 kNT, or two passes of
// 64 columns for C > 64; 2, 4 or 8).
template <typename TO, int kNT>
__global__ void __launch_bounds__(2 * kMaxRows)
tile_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y, const bf16* __restrict__ z,
                TO* __restrict__ o, Strides s, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout L(d, kNT);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + L.mx * L.ld;
  bf16* zs = reinterpret_cast<bf16*>(smem + L.z_offset());
  float* os = reinterpret_cast<float*>(smem + L.out_offset());

  const long long plane = blockIdx.x / d.tiles, tile = blockIdx.x % d.tiles;
  const int m = d.rows, c = d.cols;
  stage(x + tile_base(s, 0, plane, tile), s.v[2], s.v[3], m, d.depth, L.mx, L.kp, xs, L.ld,
        d.vec & 1);
  stage(y + tile_base(s, 1, plane, tile), s.v[6], s.v[7], d.mode == 0 ? m : c, d.depth, L.ny,
        L.kp, ys, L.ld, d.vec & 2);
  if (d.mode == 0)
    stage(z + tile_base(s, 2, plane, tile), s.v[10], s.v[11], m, c, L.nz, L.zld - 8, zs, L.zld,
          d.vec & 4);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5);  // the warp's strip
  float acc[kNT][4];
  for (int pass = 0; pass < L.passes; ++pass) {
    const int c0 = 8 * kNT * pass;  // the pass's first output column
    if (d.mode == 1) {
      strip_xyt(xs, ys + c0 * L.ld, L.ld, r0, L.kp, lane, acc);
    } else {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      for (int n0 = 0; n0 < L.ny; n0 += kChunk) {
        float sc[kChunk / 8][4];
        strip_xyt(xs, ys + n0 * L.ld, L.ld, r0, L.kp, lane, sc);
        // S rounded to bf16, fed back as the A operand of S_chunk Z_chunk
        uint32_t p[kChunk / 16][4];
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          p[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          p[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          p[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          p[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }
        strip_pz(p, zs + n0 * L.zld + c0, L.zld, lane, acc);
      }
    }
    if (L.passes == 2) write_strip(os + c0, L.old, acc, r0, lane);
  }
  if (L.passes == 1) {
    __syncthreads();  // X and Y are dead in every warp: O takes their place
    write_strip(os, L.old, acc, r0, lane);
  }
  __syncthreads();
  unstage(os, L.old, m, c, o + tile_base(s, 3, plane, tile), s.v[14], s.v[15], d.vec & 8);
}

// ---- f32 inputs: CUDA cores ------------------------------------------------

// Shared memory of the f32 kernel, floats: X^T (depth x 128), a Y chunk^T
// (depth x 64), S chunk^T (64 x (128 + 4)); then the output (128 x
// (16 kCT + 4)) over them; a Z chunk (64 x 16 kCT).
constexpr int kSLd = kSlice + 4;
struct SimtLayout {
  int front, z;
  __host__ __device__ SimtLayout(const Dims& d, int ct) {
    const int xys = d.depth * (kSlice + kChunk) + kChunk * kSLd;
    const int out = kSlice * (16 * ct + 4);
    front = xys > out ? xys : out;
    z = d.mode == 0 ? kChunk * 16 * ct : 0;
  }
  __host__ __device__ int bytes() const { return (front + z) * 4; }
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4ty + a and 64 + 4ty + a
// (a < 4) of the slice; of an S chunk columns 4tx + b (b < 4); of O columns
// kCT tx + b (b < kCT).
template <typename TO, int kCT>
__global__ void __launch_bounds__(kThreads)
tile_simt_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, TO* __restrict__ o, Strides s, Dims d) {
  extern __shared__ __align__(16) float fsm[];
  const SimtLayout L(d, kCT);
  const int m = d.rows, k = d.depth, c = d.cols;
  float* xt = fsm;                    // X^T: [k][128]
  float* yt = xt + k * kSlice;        // Y chunk^T: [k][64]
  float* stt = yt + k * kChunk;       // S chunk^T: [64][kSLd]
  float* zs = fsm + L.front;          // Z chunk: [64][16 kCT]
  float* os = fsm;                    // the output, at the end: [128][16 kCT + 4]
  constexpr int kZLd = 16 * kCT, kOLd = 16 * kCT + 4;

  const long long plane = blockIdx.x / d.tiles, tile = blockIdx.x % d.tiles;
  const int r0 = blockIdx.y * kSlice, rows = min(kSlice, m - r0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  stage_transposed(x + tile_base(s, 0, plane, tile) + r0 * s.v[2], s.v[2], s.v[3], rows, k,
                   kSlice, xt, d.vec & 1, d.vec & (1 << kColsVec));

  float acc[8][kCT];  // O (mode 0)
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < kCT; ++b) acc[a][b] = 0.f;
  const int ms = d.mode == 0 ? m : c;  // S columns needed
  const float* yb = y + tile_base(s, 1, plane, tile);
  const float* zb = z + (d.mode == 0 ? tile_base(s, 2, plane, tile) : 0);
  for (int n0 = 0; n0 < ms; n0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    stage_transposed(yb + n0 * s.v[6], s.v[6], s.v[7], min(kChunk, ms - n0), k, kChunk, yt,
                     d.vec & 2, d.vec & (2 << kColsVec));
    if (d.mode == 0)
      stage(zb + n0 * s.v[10], s.v[10], s.v[11], min(kChunk, m - n0), c, kChunk, kZLd, zs, kZLd,
            d.vec & 4);
    cp_async_wait_all();
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < k; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + kk * kSlice + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(xt + kk * kSlice + 64 + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(yt + kk * kChunk + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(av[a], bb[b], sc[a][b]);
    }

    if (d.mode == 1) {  // O = S[:, :C]: the chunk is O's columns n0 .., out through S^T's space
#pragma unroll
      for (int a = 0; a < 8; ++a)
        *reinterpret_cast<float4*>(stt + (4 * ty + a % 4 + 64 * (a / 4)) * kChunk + 4 * tx) =
            make_float4(sc[a][0], sc[a][1], sc[a][2], sc[a][3]);
      __syncthreads();
      unstage(stt, kChunk, rows, min(kChunk, c - n0),
              o + tile_base(s, 3, plane, tile) + r0 * s.v[14] + n0 * s.v[15], s.v[14], s.v[15],
              d.vec & 8);
      continue;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float* dst = stt + (4 * tx + b) * kSLd + 4 * ty;
      *reinterpret_cast<float4*>(dst) = make_float4(sc[0][b], sc[1][b], sc[2][b], sc[3][b]);
      *reinterpret_cast<float4*>(dst + 64) = make_float4(sc[4][b], sc[5][b], sc[6][b], sc[7][b]);
    }
    __syncthreads();
    const int jn = min(kChunk, m - n0);
#pragma unroll 4
    for (int j = 0; j < jn; ++j) {
      const float4 s0 = *reinterpret_cast<const float4*>(stt + j * kSLd + 4 * ty);
      const float4 s1 = *reinterpret_cast<const float4*>(stt + j * kSLd + 64 + 4 * ty);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float zv[kCT];
      if constexpr (kCT == 1) {
        zv[0] = zs[j * kZLd + tx];
      } else if constexpr (kCT == 2) {
        const float2 t = *reinterpret_cast<const float2*>(zs + j * kZLd + 2 * tx);
        zv[0] = t.x; zv[1] = t.y;
      } else {
#pragma unroll
        for (int q = 0; q < kCT; q += 4) {
          const float4 t = *reinterpret_cast<const float4*>(zs + j * kZLd + kCT * tx + q);
          zv[q] = t.x; zv[q + 1] = t.y; zv[q + 2] = t.z; zv[q + 3] = t.w;
        }
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < kCT; ++b) acc[a][b] = fmaf(sv[a], zv[b], acc[a][b]);
    }
  }
  if (d.mode == 1) return;
  __syncthreads();  // every thread is done with X^T, Y^T and S^T
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < kCT; ++b)
      os[(4 * ty + a % 4 + 64 * (a / 4)) * kOLd + kCT * tx + b] = acc[a][b];
  __syncthreads();
  unstage(os, kOLd, rows, c, o + tile_base(s, 3, plane, tile) + r0 * s.v[14], s.v[14], s.v[15],
          d.vec & 8);
}

// ---- launch ------------------------------------------------------------------

// 8-column tiles (bf16) or columns a thread (f32) for C output columns.
int mma_tiles(int c) { return c <= 16 ? 2 : c <= 32 ? 4 : 8; }
int simt_cols(int c) { return c <= 16 ? 1 : c <= 32 ? 2 : c <= 64 ? 4 : 8; }

template <typename TO, int kNT>
cudaError_t launch_mma(const void* x, const void* y, const void* z, void* o, const Strides& s,
                       long long planes, const Dims& d, cudaStream_t stream) {
  const int bytes = MmaLayout(d, kNT).bytes();
  cudaError_t err = cudaFuncSetAttribute(tile_mma_kernel<TO, kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  tile_mma_kernel<TO, kNT><<<static_cast<unsigned>(planes * d.tiles),
                             MmaLayout(d, kNT).threads(), bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<const bf16*>(z),
      static_cast<TO*>(o), s, d);
  return cudaGetLastError();
}

template <typename TO, int kCT>
cudaError_t launch_simt(const void* x, const void* y, const void* z, void* o, const Strides& s,
                        long long planes, const Dims& d, cudaStream_t stream) {
  const int bytes = SimtLayout(d, kCT).bytes();
  cudaError_t err = cudaFuncSetAttribute(tile_simt_kernel<TO, kCT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(planes * d.tiles), (d.rows + kSlice - 1) / kSlice);
  tile_simt_kernel<TO, kCT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(z),
      static_cast<TO*>(o), s, d);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_out(int in_dtype, const void* x, const void* y, const void* z, void* o,
                       const Strides& s, long long planes, const Dims& d, cudaStream_t st) {
  if (in_dtype == 1) {
    switch (mma_tiles(d.cols)) {
      case 2: return launch_mma<TO, 2>(x, y, z, o, s, planes, d, st);
      case 4: return launch_mma<TO, 4>(x, y, z, o, s, planes, d, st);
      default: return launch_mma<TO, 8>(x, y, z, o, s, planes, d, st);
    }
  }
  switch (simt_cols(d.cols)) {
    case 1: return launch_simt<TO, 1>(x, y, z, o, s, planes, d, st);
    case 2: return launch_simt<TO, 2>(x, y, z, o, s, planes, d, st);
    case 4: return launch_simt<TO, 4>(x, y, z, o, s, planes, d, st);
    default: return launch_simt<TO, 8>(x, y, z, o, s, planes, d, st);
  }
}

// Whether every row (cols elements of es bytes, column stride 1) of every
// tile of an operand is a run of 16-byte aligned chunks; with rs and cs
// swapped, every column.
bool aligned_runs(const void* p, const long long* st, int row, int col, int n, int es) {
  if (p == nullptr || st[col] != 1 || (n * es) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return false;
  return (st[0] * es) % 16 == 0 && (st[1] * es) % 16 == 0 && (st[row] * es) % 16 == 0;
}

// Operand flags (Dims::vec) for in and out element sizes.
int vector_flags(const void* const* ptrs, const long long* st, const Dims& d, int es, int oes) {
  int vec = 0;
  const int width[4] = {d.depth, d.depth, d.cols, d.cols};
  for (int op = 0; op < 4; ++op) {
    const long long* t = st + 4 * op;
    const int e = op == 3 ? oes : es;
    if (aligned_runs(ptrs[op], t, 2, 3, width[op], e)) vec |= 1 << op;
    if (op < 2 && aligned_runs(ptrs[op], t, 3, 2, d.rows, e)) vec |= 1 << (kColsVec + op);
  }
  return vec;
}

bool valid(long long planes, long long tiles, int rows, int depth, int cols, int mode,
           int in_dtype, int out_dtype) {
  return planes > 0 && tiles > 0 && planes * tiles <= 0x7fffffffLL && rows >= 1 &&
         rows <= kMaxRows && depth >= 1 && depth <= kMaxDepth && cols >= 1 && cols <= kMaxCols &&
         cols <= rows && (mode == 0 || mode == 1) && (in_dtype == 0 || in_dtype == 1) &&
         (out_dtype == 0 || out_dtype == 1);
}

}  // namespace

// x, y: (planes, tiles, rows, depth) views, z: (planes, tiles, rows, cols)
// (mode 0; unused in mode 1), o: (planes, tiles, rows, cols), each given by
// its base pointer and 4 strides in `strides` (host memory, 16 int64:
// x, y, z, o). rows <= 256, depth <= 128, cols <= 128 and cols <= rows.
// Types: 0 = float32, 1 = bfloat16 (x, y, z share in_dtype). Returns a
// cudaError_t (0 = launched).
extern "C" int tile_matmul(const void* x, const void* y, const void* z, void* o,
                           const void* strides, long long planes, long long tiles, int rows,
                           int depth, int cols, int mode, int in_dtype, int out_dtype,
                           void* stream) {
  if (!valid(planes, tiles, rows, depth, cols, mode, in_dtype, out_dtype) ||
      (mode == 0 && z == nullptr) || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s;
  for (int i = 0; i < 16; ++i) s.v[i] = static_cast<const long long*>(strides)[i];
  Dims d{tiles, rows, depth, cols, mode, 0};
  const void* ptrs[4] = {x, y, mode == 0 ? z : nullptr, o};
  d.vec = vector_flags(ptrs, s.v, d, in_dtype == 0 ? 4 : 2, out_dtype == 0 ? 4 : 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return static_cast<int>(launch_out<float>(in_dtype, x, y, z, o, s, planes, d, st));
  return static_cast<int>(launch_out<bf16>(in_dtype, x, y, z, o, s, planes, d, st));
}

// The dynamic shared memory (bytes) and threads of one block for tiles of
// `rows` x `depth` with `cols` output columns in `mode`, input dtype code
// `in_dtype`. Returns a cudaError_t.
extern "C" int tile_matmul_block(int rows, int depth, int cols, int mode, int in_dtype, int* smem,
                                 int* threads) {
  if (!valid(1, 1, rows, depth, cols, mode, in_dtype, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{1, rows, depth, cols, mode, 0};
  const MmaLayout mma(d, mma_tiles(cols));
  *smem = in_dtype == 1 ? mma.bytes() : SimtLayout(d, simt_cols(cols)).bytes();
  *threads = in_dtype == 1 ? mma.threads() : kThreads;
  return 0;
}
