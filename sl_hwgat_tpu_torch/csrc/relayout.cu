// Axis permutation of a contiguous tensor of up to 4 axes, for Hopper (sm_90a).
//
// Replaces the relayout probes of bench_kernel.py: xrelay_s0pallas /
// xrelay_s2pallas, (g, n, h, dh) -> (g, h, n, dh) (the pallas_call at
// :1138), and xstrided_s0 / xstrided_s2, (g, n, h, dh) -> (h, g, n, dh)
// (:1201). It also carries the TPU layouts of the fused probes to and from
// the token-major (U, N, dh) layout of the window-attention kernel
// (ops/layouts.py): the (T, dh, SN) supertile transposes, the model-wide
// (H, DH, TH*SN) planes, the lane-packed pairs and the banded planes.
//
// o[j0, j1, j2, j3] = x[i] with i[perm[m]] = j[m]; the input has shape
// (d0, d1, d2, d3), leading axes of size 1 where it has fewer.
//
//   innermost axis stays (perm[3] == 3): a gather of whole rows, one 16-byte
//     word a thread where the row allows it (else 4- or 2-byte words);
//   innermost axis moves: a tiled transpose of the input's innermost axis
//     and the output's innermost axis through shared memory, 32 x 32 tiles
//     padded by one column so neither the column reads nor the row writes
//     conflict on a bank; the two other axes index the tiles.
//
// Bound on an H100 SXM: bytes, the tensor read once and written once:
// 100.7 MB for the bench's 12288 x 32 x 64 bf16 one way, 30 us at 3.35 TB/s.
// Both paths read and write whole 32-byte sectors: the gather moves rows of
// 128 bytes (dh 64, bf16) as 16-byte words, the transpose reads and writes
// runs of 32 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // the transpose's block is 32 x 8 threads
constexpr int kGatherThreads = 256;

struct Shape {
  long long d[4];      // input shape
  long long istr[4];   // input strides (elements)
  long long ostr[4];   // stride in the output of each INPUT axis
  long long od[4];     // output shape
  int perm[4];
};

// Row gather: the word w of output row r comes from the input row that
// holds the same indices of axes 0-2.
template <typename W>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows(const W* __restrict__ x, W* __restrict__ o, Shape s, long long words_per_row) {
  const long long rows = s.od[0] * s.od[1] * s.od[2];
  const long long total = rows * words_per_row;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long w = idx % words_per_row;
    long long r = idx / words_per_row;
    const long long j2 = r % s.od[2];
    r /= s.od[2];
    const long long j1 = r % s.od[1];
    const long long j0 = r / s.od[1];
    // input row index: sum over output axes m of j_m * (input row stride of
    // axis perm[m]); input row strides are istr / d3.
    const long long in_row = j0 * (s.istr[s.perm[0]] / s.d[3]) +
                             j1 * (s.istr[s.perm[1]] / s.d[3]) +
                             j2 * (s.istr[s.perm[2]] / s.d[3]);
    o[idx] = x[in_row * words_per_row + w];
  }
}

// Tiled transpose of input axis 3 (contiguous in x) and input axis `a`
// (contiguous in o); the other two input axes b1 < b2 index the tiles.
template <typename T>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
transpose_tiles(const T* __restrict__ x, T* __restrict__ o, Shape s, int a, int b1, int b2) {
  __shared__ T tile[kTile][kTile + 1];
  const long long tiles3 = (s.d[3] + kTile - 1) / kTile;
  const long long tilesa = (s.d[a] + kTile - 1) / kTile;
  const long long batch = s.d[b1] * s.d[b2];
  for (long long z = blockIdx.z; z < batch; z += gridDim.z) {
    const long long ib1 = z / s.d[b2], ib2 = z % s.d[b2];
    const long long ibase = ib1 * s.istr[b1] + ib2 * s.istr[b2];
    const long long obase = ib1 * s.ostr[b1] + ib2 * s.ostr[b2];
    for (long long ta = blockIdx.y; ta < tilesa; ta += gridDim.y) {
      for (long long t3 = blockIdx.x; t3 < tiles3; t3 += gridDim.x) {
        const long long i3 = t3 * kTile + threadIdx.x;
#pragma unroll
        for (int r = 0; r < kTile; r += kRowsPerPass) {
          const long long ia = ta * kTile + threadIdx.y + r;
          if (ia < s.d[a] && i3 < s.d[3])
            tile[threadIdx.y + r][threadIdx.x] = x[ibase + ia * s.istr[a] + i3];
        }
        __syncthreads();
        const long long ia = ta * kTile + threadIdx.x;
#pragma unroll
        for (int r = 0; r < kTile; r += kRowsPerPass) {
          const long long j3 = t3 * kTile + threadIdx.y + r;
          if (ia < s.d[a] && j3 < s.d[3])
            o[obase + ia + j3 * s.ostr[3]] = tile[threadIdx.x][threadIdx.y + r];
        }
        __syncthreads();
      }
    }
  }
}

unsigned capped(long long n, long long cap) {
  return static_cast<unsigned>(n < 1 ? 1 : (n > cap ? cap : n));
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* o, const Shape& s, cudaStream_t stream) {
  const int a = s.perm[3];
  int b[2], nb = 0;
  for (int k = 0; k < 3; ++k)
    if (k != a) b[nb++] = k;
  const dim3 grid(capped((s.d[3] + kTile - 1) / kTile, 1 << 30),
                  capped((s.d[a] + kTile - 1) / kTile, 65535),
                  capped(s.d[b[0]] * s.d[b[1]], 65535));
  transpose_tiles<T><<<grid, dim3(kTile, kRowsPerPass), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), s, a, b[0], b[1]);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_gather(const void* x, void* o, const Shape& s, int elem_bytes,
                          cudaStream_t stream) {
  const long long words_per_row = s.d[3] * elem_bytes / static_cast<long long>(sizeof(W));
  const long long total = s.od[0] * s.od[1] * s.od[2] * words_per_row;
  gather_rows<W><<<capped((total + kGatherThreads - 1) / kGatherThreads, 1LL << 30),
                   kGatherThreads, 0, stream>>>(static_cast<const W*>(x), static_cast<W*>(o),
                                                s, words_per_row);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (d0, d1, d2, d3) of elem_bytes (2 or 4) bytes each; o:
// contiguous output of shape (d[p0], d[p1], d[p2], d[p3]); p a permutation
// of 0..3. Returns a cudaError_t (0 = launched).
extern "C" int relayout(const void* x, void* o, long long d0, long long d1, long long d2,
                        long long d3, int p0, int p1, int p2, int p3, int elem_bytes,
                        void* stream) {
  Shape s{};
  const long long d[4] = {d0, d1, d2, d3};
  const int p[4] = {p0, p1, p2, p3};
  int seen = 0;
  for (int k = 0; k < 4; ++k) {
    if (d[k] <= 0 || p[k] < 0 || p[k] > 3) return static_cast<int>(cudaErrorInvalidValue);
    seen |= 1 << p[k];
    s.d[k] = d[k];
    s.perm[k] = p[k];
  }
  if (seen != 0xf || (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  s.istr[3] = 1;
  for (int k = 2; k >= 0; --k) s.istr[k] = s.istr[k + 1] * d[k + 1];
  for (int m = 0; m < 4; ++m) s.od[m] = d[p[m]];
  long long stride = 1;
  for (int m = 3; m >= 0; --m) {
    s.ostr[p[m]] = stride;
    stride *= s.od[m];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p[3] != 3) {
    return static_cast<int>(elem_bytes == 2 ? launch_transpose<uint16_t>(x, o, s, st)
                                            : launch_transpose<uint32_t>(x, o, s, st));
  }
  const long long row_bytes = d3 * elem_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (aligned && row_bytes % 16 == 0)
    return static_cast<int>(launch_gather<uint4>(x, o, s, elem_bytes, st));
  if (elem_bytes == 4 || row_bytes % 4 == 0)
    return static_cast<int>(launch_gather<uint32_t>(x, o, s, elem_bytes, st));
  return static_cast<int>(launch_gather<uint16_t>(x, o, s, elem_bytes, st));
}
