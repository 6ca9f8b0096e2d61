// Axis permutation of a contiguous tensor of up to 4 axes, for Hopper (sm_90a).
//
// Replaces the relayout probes of bench_kernel.py: xrelay_s0pallas /
// xrelay_s2pallas, (g, n, h, dh) -> (g, h, n, dh) (the pallas_call at
// :1138), and xstrided_s0 / xstrided_s2, (g, n, h, dh) -> (h, g, n, dh)
// (:1201). It also carries the TPU layouts of the bench's probes to and
// from the token-major (U, N, dh) layout (ops/layouts.py): the transposed
// streams of the mm_*nt* entries, the (T, dh, SN) supertiles, the
// model-wide (H, DH, TH*SN) planes, the lane-packed pairs and the banded
// planes of the packedpre entries.
//
// o[j0, j1, j2, j3] = x[i] with i[perm[m]] = j[m]; the input has shape
// (d0, d1, d2, d3), leading axes of size 1 where it has fewer.
//
//   innermost axis stays (perm[3] == 3): a gather of whole rows, one 16-byte
//     word a thread where the row allows it (else 4- or 2-byte words);
//   innermost axis moves, the input's axis 3 and its axis a = perm[3] (the
//     output's innermost) swap; the two other axes index the tiles:
//     - both axes a multiple of E elements a 16-byte word (E = 8 in 2 bytes,
//       4 in 4 bytes) and both pointers 16-byte aligned: each lane moves
//       E x E blocks, 16 bytes a thread on both sides. It loads E rows of E
//       elements along axis 3 (16-byte words), transposes the block in
//       registers (2 bytes: pairs of rows merged into 32-bit words by
//       prmt; the 32-bit words then only change registers; 4 bytes: no
//       instruction at all), and stores E rows of E elements along a. A
//       warp takes a tile of 64 x 64 two-byte or 64 x 32 four-byte elements
//       (a x 3; narrower along an axis with fewer blocks, wider along the
//       other), 8 lanes along axis 3 reading 128 contiguous bytes of a row,
//       4 lanes along a writing 64 contiguous bytes of an output row, and
//       walks the tiles in a grid-stride loop over as many blocks as the card holds
//       at once; no shared memory, so no bank conflicts; 32-bit index
//       arithmetic where the tensor has fewer than 2^31 elements;
//     - any other size or alignment: 32 x 32 tiles through shared memory,
//       padded by one column so neither the column reads nor the row writes
//       conflict on a bank, one element a thread.
//
// Bound on an H100 SXM: bytes, the tensor read once and written once:
// 100.7 MB for the bench's 12288 x 32 x 64 bf16 one way, 30 us at 3.35 TB/s.
// Every path reads and writes whole 32-byte sectors: the gather moves rows
// of 128 bytes (dh 64, bf16) as 16-byte words, the block transpose 128-byte
// runs in and 64-byte runs out, the tiled one runs of 32 elements. The
// design before the block transpose (32 x 32 tiles, 2-byte elements one at
// a time, 64-bit indices: about 24k blocks of 256 threads for one 50 MB
// tensor, 2 KB each) took 0.107 ms for the bench's transpose (NVIDIA H100 80GB HBM3,
// 700 W).

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
// (contiguous in o); the other two input axes b1 < b2 index the tiles. The
// path for sizes and alignments the block transpose does not take.
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

// The block transpose's geometry: sizes and strides in elements, the tiles
// of the grid-stride loop, and the warp's lanes along axis 3 (1 << lg_bc).
template <typename I>
struct Blocks {
  I d3, da, nb2;                // sizes of input axes 3, a and b2
  I istr_a, istr_b1, istr_b2;   // input strides of axes a, b1, b2
  I ostr_3, ostr_b1, ostr_b2;   // output strides of input axes 3, b1, b2 (a: 1)
  I tiles_3, tiles_a, tiles;    // warp tiles along 3, along a, in all
  int lg_bc;
};

constexpr int kBlockThreads = 256;

// 16 bytes of E elements as 4 32-bit words.
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[4]) {
  const uint4 x = __ldg(static_cast<const uint4*>(p));
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
}
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[4]) {
  *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// An E x E block, rows in[k] (E elements of one row, as 4 words), into
// out[c] = column c (element k of out[c] = element c of in[k]).
__device__ __forceinline__ void transpose_block(const uint32_t (&in)[8][4], uint32_t (&out)[8][4]) {
  // 2-byte elements: word m of row k holds columns 2m (low half) and
  // 2m + 1; word n of column c holds rows 2n and 2n + 1
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      out[2 * m][n] = __byte_perm(in[2 * n][m], in[2 * n + 1][m], 0x5410);
      out[2 * m + 1][n] = __byte_perm(in[2 * n][m], in[2 * n + 1][m], 0x7632);
    }
}
__device__ __forceinline__ void transpose_block(const uint32_t (&in)[4][4], uint32_t (&out)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[c][k] = in[k][c];
}

// The block transpose: T the element type (2 or 4 bytes), kE = 16 /
// sizeof(T) elements a word, kPer = 16 / kE blocks a lane (stacked along a,
// 16 words in flight a thread), I the index type.
template <typename T, typename I>
__global__ void __launch_bounds__(kBlockThreads)
transpose_blocks(const T* __restrict__ x, T* __restrict__ o, const Blocks<I> s) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr int kPer = 16 / kE;
  const int lane = threadIdx.x & 31;
  const int bc = 1 << s.lg_bc, br = 32 >> s.lg_bc;  // lanes along 3 and along a
  const int lr = lane >> s.lg_bc, lc = lane & (bc - 1);
  const I warps = static_cast<I>(gridDim.x) * (kBlockThreads / 32);
  for (I wt = static_cast<I>(blockIdx.x) * (kBlockThreads / 32) + (threadIdx.x >> 5); wt < s.tiles;
       wt += warps) {
    const I t3 = wt % s.tiles_3, r = wt / s.tiles_3;
    const I ta = r % s.tiles_a, z = r / s.tiles_a;
    const I i3 = (t3 * bc + lc) * kE;
    if (i3 >= s.d3) continue;
    const I ib1 = z / s.nb2, ib2 = z % s.nb2;
    const I ibase = ib1 * s.istr_b1 + ib2 * s.istr_b2 + i3;
    const I obase = ib1 * s.ostr_b1 + ib2 * s.ostr_b2 + i3 * s.ostr_3;
    uint32_t in[kPer][kE][4];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const I ia = ((ta * kPer + p) * br + lr) * kE;
      if (ia < s.da)
#pragma unroll
        for (int k = 0; k < kE; ++k) load_words(x + ibase + (ia + k) * s.istr_a, in[p][k]);
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const I ia = ((ta * kPer + p) * br + lr) * kE;
      if (ia < s.da) {
        uint32_t out[kE][4];
        transpose_block(in[p], out);
#pragma unroll
        for (int c = 0; c < kE; ++c) store_words(o + obase + c * s.ostr_3 + ia, out[c]);
      }
    }
  }
}

unsigned capped(long long n, long long cap) {
  return static_cast<unsigned>(n < 1 ? 1 : (n > cap ? cap : n));
}

// Blocks of the kernel resident on one SM of the current device at once
// (asked once per kernel).
template <typename K>
int resident_blocks(K kernel, int& cache) {
  if (cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, 0) !=
            cudaSuccess)
      return 0;
    cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache;
}

// The block transpose where Shape s allows it (see above); false where it
// does not.
template <typename T, typename I>
bool launch_blocks(const void* x, void* o, const Shape& s, int a, int b1, int b2,
                   cudaStream_t stream, cudaError_t& err) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  constexpr long long kPer = 16 / kE;
  if (s.d[3] % kE != 0 || s.d[a] % kE != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0)
    return false;
  const long long n3 = s.d[3] / kE, na = s.d[a] / kE;  // blocks along 3 and a
  // 8 lanes along 3 and 4 along a; fewer along 3 where it has fewer blocks,
  // fewer along a where a has fewer blocks than lanes (the lanes along a of
  // one output row write its 16-byte chunks side by side: whole sectors)
  int lg_bc = 3;
  while (lg_bc > 0 && (1LL << (lg_bc - 1)) >= n3) --lg_bc;
  while (lg_bc < 5 && (1LL << lg_bc) < n3 && (32LL >> lg_bc) > na) ++lg_bc;
  Blocks<I> g;
  g.d3 = static_cast<I>(s.d[3]);
  g.da = static_cast<I>(s.d[a]);
  g.nb2 = static_cast<I>(s.d[b2]);
  g.istr_a = static_cast<I>(s.istr[a]);
  g.istr_b1 = static_cast<I>(s.istr[b1]);
  g.istr_b2 = static_cast<I>(s.istr[b2]);
  g.ostr_3 = static_cast<I>(s.ostr[3]);
  g.ostr_b1 = static_cast<I>(s.ostr[b1]);
  g.ostr_b2 = static_cast<I>(s.ostr[b2]);
  const long long tiles_3 = (n3 + (1LL << lg_bc) - 1) >> lg_bc;
  const long long rows_a = (32LL >> lg_bc) * kPer;  // blocks along a a tile
  const long long tiles_a = (na + rows_a - 1) / rows_a;
  const long long tiles = tiles_3 * tiles_a * s.d[b1] * s.d[b2];
  g.tiles_3 = static_cast<I>(tiles_3);
  g.tiles_a = static_cast<I>(tiles_a);
  g.tiles = static_cast<I>(tiles);
  g.lg_bc = lg_bc;
  static int cache = 0;
  const auto kernel = transpose_blocks<T, I>;
  const long long resident = resident_blocks(kernel, cache);
  const long long wanted = (tiles + kBlockThreads / 32 - 1) / (kBlockThreads / 32);
  kernel<<<capped(wanted, resident > 0 ? resident : 65535), kBlockThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), g);
  err = cudaGetLastError();
  return true;
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* o, const Shape& s, cudaStream_t stream) {
  const int a = s.perm[3];
  int b[2], nb = 0;
  for (int k = 0; k < 3; ++k)
    if (k != a) b[nb++] = k;
  cudaError_t err = cudaSuccess;
  const long long elems = s.d[0] * s.d[1] * s.d[2] * s.d[3];
  if (elems < (1LL << 31) ? launch_blocks<T, uint32_t>(x, o, s, a, b[0], b[1], stream, err)
                          : launch_blocks<T, unsigned long long>(x, o, s, a, b[0], b[1], stream, err))
    return err;
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

// The block transpose's threads a block and elements of a warp's tile (the
// widest, 8 lanes along axis 3) for `elem_bytes` (2 or 4). Returns a
// cudaError_t.
extern "C" int relayout_block(int elem_bytes, int* threads, int* tile_elems) {
  if (elem_bytes != 2 && elem_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int e = 16 / elem_bytes, per = 16 / e;  // elements a word, blocks a lane
  *threads = kBlockThreads;
  *tile_elems = (4 * per * e) * (8 * e);
  return 0;
}
