// Shared by the masked-softmax forward and backward kernels (sm_90a).
//
// The backward recomputes the forward's probabilities A from the saved raw
// scores. Both call masked_softmax_row below, so A and the set of entries it
// keeps are the same bit for bit in the two passes: a prune decision at the
// `u` boundary cannot flip between them, and the gradient is gated by
// exactly the entries the forward kept. The masking rules are those of the
// window-attention kernels (window_attention_common.cuh, whose type helpers
// and mask-plane choice this header uses).
//
// Layout: per-unit scores (U, n, n), f32 or bf16 (upcast to f32 on load),
// n <= 64. A row is held by a group of kLanes lanes of a warp (8 for n <= 32,
// 16 for n <= 64), four columns a lane, so a warp takes 32 / kLanes rows at
// once. Which four, by n alone
// (so both kernels agree whatever their pointers): for n a multiple of 4,
// lane l of the group holds 4l .. 4l + 3 (16 contiguous bytes of f32, one
// load); for other even n (HGATE's 58), the pairs 2l, 2l + 1
// and 2l + 2 kLanes, 2l + 2 kLanes + 1 (rows of 58 floats are only 8-byte
// aligned); for odd n, l + kLanes c. The reductions run over the lane's
// four columns in order, then across the group by xor shuffles. Row masks
// are (2, n) 64-bit words, bit j = key token j.
//
// Both kernels run blocks of kWarps warps over spans of rows staged in
// shared memory (SpanRows, staged_spans); the backward on f32 scores and f32
// dP over 128 / n whole units read in device memory (BlockRows). A block
// looks up each unit's mask plane once.

#pragma once

#include <math.h>

#include <atomic>

#include "window_attention_common.cuh"

namespace msoft {

using wattn::kNeg;

constexpr int kPer = 4;  // columns a lane holds
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinRows = 128;  // a direct block takes max(1, kMinRows / n) units

__host__ __device__ __forceinline__ int units_per_block(int n) {
  return n >= kMinRows ? 1 : kMinRows / n;
}

// The column maps above, chosen by n.
enum ColumnMap { kQuads, kPairs, kSingles };

__host__ __device__ __forceinline__ int column_map(int n) {
  return n % 4 == 0 ? kQuads : n % 2 == 0 ? kPairs : kSingles;
}

// The column of the c-th value of lane l of a row group.
template <int kLanes, int kMap>
__device__ __forceinline__ int column(int l, int c) {
  return kMap == kQuads ? kPer * l + c
         : kMap == kPairs ? 2 * l + (c & 1) + 2 * kLanes * (c >> 1)
                          : l + kLanes * c;
}

template <int kLanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One row of raw scores `s` (this lane's columns column(l, c); entries at
// columns >= n are ignored) -> its probabilities `a` (0 at columns >= n):
//   prune: P0 = softmax(s), s[P0 > u] = 0, u read from device memory;
//   s[!allowed | (zero_quirk & s == 0)] = kNeg;  a = softmax(s).
// Returns bit c set where column(l, c) passes the gradient (the masked
// score still equals the raw one; the prune mask is not differentiated).
// Every lane of the warp calls it (the shuffles span the warp); a group
// with no row passes n and allowed = 0 and ignores the result.
template <int kLanes, int kMap>
__device__ __forceinline__ unsigned masked_softmax_row(const float (&s)[kPer], int l, int n,
                                                       unsigned long long allowed,
                                                       const float* __restrict__ prune_u,
                                                       int zero_quirk, float (&a)[kPer]) {
  unsigned pruned = 0u;
  if (prune_u != nullptr) {
    const float u = __ldg(prune_u);
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (column<kLanes, kMap>(l, c) < n) m = fmaxf(m, s[c]);
    m = group_max<kLanes>(m);
    float e[kPer], total = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      e[c] = column<kLanes, kMap>(l, c) < n ? expf(s[c] - m) : 0.f;
      total += e[c];
    }
    total = group_sum<kLanes>(total);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (column<kLanes, kMap>(l, c) < n && e[c] / total > u) pruned |= 1u << c;
  }

  unsigned pass = 0u;
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    a[c] = 0.f;
    if (j < n) {
      const float sp = ((pruned >> c) & 1u) ? 0.f : s[c];
      const bool keep = ((allowed >> j) & 1ull) && (!zero_quirk || sp != 0.f);
      a[c] = keep ? sp : kNeg;
      if (a[c] == s[c]) pass |= 1u << c;
      m = fmaxf(m, a[c]);
    }
  }
  m = group_max<kLanes>(m);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    a[c] = column<kLanes, kMap>(l, c) < n ? expf(a[c] - m) : 0.f;
    sum += a[c];
  }
  const float inv = 1.f / group_sum<kLanes>(sum);
#pragma unroll
  for (int c = 0; c < kPer; ++c) a[c] *= inv;
  return pass;
}

// `p`'s value: through the read-only path from device memory (kGlobal), or
// a plain load (a staged row in shared memory).
template <bool kGlobal, typename V>
__device__ __forceinline__ V read(const V* p) {
  if constexpr (kGlobal) return __ldg(p);
  else return *p;
}

// This lane's columns of a row of n values at `row` (in device memory, or
// in shared memory for !kGlobal), as f32 (0 beyond n). `vec`: the tensor is
// 16-byte aligned, so that quads (f32: 16 bytes, bf16: 8) and pairs (8, 4)
// load at once.
template <int kLanes, int kMap, bool kGlobal = true>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int l, int n, bool vec,
                                          float (&x)[kPer]) {
  if (vec && kMap == kQuads) {
    const float4 v = kPer * l < n ? read<kGlobal>(reinterpret_cast<const float4*>(row) + l)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    return;
  }
  if (vec && kMap == kPairs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      const float2 v = j < n ? read<kGlobal>(reinterpret_cast<const float2*>(row + j))
                             : make_float2(0.f, 0.f);
      x[2 * h] = v.x;
      x[2 * h + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    x[c] = j < n ? read<kGlobal>(row + j) : 0.f;
  }
}
template <int kLanes, int kMap, bool kGlobal = true>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* __restrict__ row, int l, int n,
                                          bool vec, float (&x)[kPer]) {
  if (!kGlobal && vec && kMap == kQuads) {  // a staged quad: one 8-byte load
    uint2 w = make_uint2(0u, 0u);
    if (kPer * l < n) w = reinterpret_cast<const uint2*>(row)[l];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
    return;
  }
  if (vec && kMap != kSingles) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      float2 v = make_float2(0.f, 0.f);
      if (j < n) {
        const unsigned w = read<kGlobal>(reinterpret_cast<const unsigned*>(row + j));
        __nv_bfloat162 b;
        *reinterpret_cast<unsigned*>(&b) = w;
        v = __bfloat1622float2(b);
      }
      x[2 * h] = v.x;
      x[2 * h + 1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    x[c] = j < n ? __bfloat162float(row[j]) : 0.f;
  }
}

// x -> this lane's columns (those below n) of the row at `row`, in T (in
// device memory, or in shared memory for !kGlobal).
template <int kLanes, int kMap, bool kGlobal = true>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int l, int n, bool vec,
                                           const float (&x)[kPer]) {
  if (vec && kMap == kQuads) {
    if (kPer * l < n) reinterpret_cast<float4*>(row)[l] = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
  if (vec && kMap == kPairs) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      if (j < n) *reinterpret_cast<float2*>(row + j) = make_float2(x[2 * h], x[2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    if (j < n) row[j] = x[c];
  }
}
template <int kLanes, int kMap, bool kGlobal = true>
__device__ __forceinline__ void store_cols(__nv_bfloat16* __restrict__ row, int l, int n,
                                           bool vec, const float (&x)[kPer]) {
  if (!kGlobal && vec && kMap == kQuads) {  // a staged quad: one 8-byte store
    if (kPer * l < n) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
      reinterpret_cast<uint2*>(row)[l] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                                    *reinterpret_cast<const unsigned*>(&hi));
    }
    return;
  }
  if (vec && kMap != kSingles) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = column<kLanes, kMap>(l, 2 * h);
      if (j < n)
        *reinterpret_cast<__nv_bfloat162*>(row + j) = __floats2bfloat162_rn(x[2 * h],
                                                                          x[2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int j = column<kLanes, kMap>(l, c);
    if (j < n) row[j] = __float2bfloat16_rn(x[c]);
  }
}

// The direct design's rows (the backward on f32 scores and dP): units
// [u0, u0 + count) of n tokens, count = units_per_block(n) but at the end,
// read and written in device memory by each lane; the place of this lane:
// row group g of its warp, lane l of the group.
template <int kLanes>
struct BlockRows {
  long long u0;
  int count, n, g, l;

  // Group grp of `units` units.
  __device__ static __forceinline__ BlockRows of(long long grp, long long units, int n) {
    const int upb = units_per_block(n);
    const long long u0 = grp * upb;
    const int lane = threadIdx.x & 31;
    return BlockRows{u0, static_cast<int>(units - u0 < upb ? units - u0 : upb), n,
                     lane / kLanes, lane % kLanes};
  }

  // The mask plane of each unit into plane[0 .. count) (plain adjacency or
  // the shifted blocks' tail plane, as the window-attention kernels choose
  // it): once per unit, by the first threads of the block.
  __device__ __forceinline__ void planes(int* plane, int dual, const int* __restrict__ sel,
                                         int stack, int per_group, int groups,
                                         long long unit_offset) const {
    if (static_cast<int>(threadIdx.x) < count)
      plane[threadIdx.x] =
          wattn::mask_plane(u0 + threadIdx.x, dual, sel, stack, per_group, groups, unit_offset);
  }

  // The warp takes rows base + 0 .. base + 32 / kLanes - 1 (group g row
  // base + g) for base = first(), first() + kStep, ... while base < rows().
  __device__ __forceinline__ int first() const { return (threadIdx.x >> 5) * (32 / kLanes); }
  static constexpr int kStep = kWarps * (32 / kLanes);
  __device__ __forceinline__ int rows() const { return count * n; }

  // Row r's offset from the block's first unit, and its adjacency bits (0
  // for a row past the block's end, whose group computes nothing stored).
  __device__ __forceinline__ long long offset(int r) const {
    return (u0 * n + r) * static_cast<long long>(n);
  }
  __device__ __forceinline__ unsigned long long allowed(
      const unsigned long long* __restrict__ masks, const int* plane, int r) const {
    if (r >= rows()) return 0ull;
    const int unit = r / n;
    return __ldg(masks + plane[unit] * n + (r - unit * n));
  }
};

// The place of this lane among a span's rows: row group g of its warp,
// lane l of the group. The warp takes rows base + 0 .. base + 32 / kLanes - 1
// (group g row base + g) for base = first(), first() + kStep, ... while
// base is below the span's rows.
template <int kLanes>
struct SpanRows {
  int g, l;
  static constexpr int kStep = kWarps * (32 / kLanes);

  __device__ static __forceinline__ SpanRows here() {
    const int lane = threadIdx.x & 31;
    return SpanRows{lane / kLanes, lane % kLanes};
  }
  __device__ __forceinline__ int first() const { return (threadIdx.x >> 5) * (32 / kLanes); }

  // The mask plane of each of the span's units u0 .. u0 + count - 1 into
  // plane[0 .. count) (plain adjacency or the shifted blocks' tail plane, as
  // the window-attention kernels choose it): once per unit, by the first
  // threads of the block.
  __device__ __forceinline__ void planes(int* plane, long long u0, int count, int dual,
                                         const int* __restrict__ sel, int stack, int per_group,
                                         int groups, long long unit_offset) const {
    if (static_cast<int>(threadIdx.x) < count)
      plane[threadIdx.x] =
          wattn::mask_plane(u0 + threadIdx.x, dual, sel, stack, per_group, groups, unit_offset);
  }

  // The adjacency bits of the span's row r, row first + r of its units,
  // from the staged masks (0 for a row past the span's end, whose group
  // computes nothing stored).
  __device__ __forceinline__ unsigned long long allowed(const unsigned long long* masks,
                                                        const int* plane, int r, int rows,
                                                        int first, int n) const {
    if (r >= rows) return 0ull;
    const int row = first + r, unit = row / n;
    return masks[plane[unit] * n + (row - unit * n)];
  }
};

// ---- Spans staged whole in shared memory (Hopper's bulk copies) ----------
//
// The scores of consecutive rows, whatever units they fall in, are one
// contiguous span of each tensor. staged_spans below copies the span of
// each input into shared memory with a 1-D bulk copy (cp.async.bulk, the
// TMA's non-tensor form: one thread issues it, completion lands on an
// mbarrier, no register or instruction of the other threads is spent on
// it), runs the rows there into an output stage, and stores the output
// span back with one bulk copy. A bulk copy moves whole 16-byte chunks,
// 16-byte aligned in device and in shared memory; so a tensor's span sits
// in its buffer at the offset its first entry has from a 16-byte boundary
// in device memory (`lead`). A load takes the chunks the span touches (a
// few bytes of the neighbouring rows besides, never outside the tensor); a
// store takes the chunks inside the span, and the block's threads store the
// few entries before and after them (the head and tail of a span whose
// start or end is not on a 16-byte boundary: 33-token units, a tensor off a
// 16-byte boundary), in the same kernel.
//
// A block walks spans blockIdx.x, blockIdx.x + gridDim.x, ... (a grid of
// the resident blocks), each span whole passes of its warps over rows,
// through kInStages input stages, the next span's copies in flight while
// this one's rows run, and kOutStages output stages, so that a store leaves
// while the next span's rows run. Two barriers a span: its copies and edges
// in place; its rows done.

constexpr int kStageBytes = 24576;  // a stage's input and output bytes, about
constexpr int kMaxSpanUnits = 128;  // and the most units a span touches
constexpr int kInStages = 2;        // spans whose copies are in flight a block
constexpr int kOutStages = 2;       // spans whose output a block stores at once
// Blocks an SM that ptxas leaves registers for at 16 lanes a row: unbounded,
// ptxas holds some instantiations to 64 registers and spills.
constexpr int kMinBlocks = 4;

// Bytes of a staging buffer for a span of `entries` entries of `size`
// bytes: its lead, the entries and the end of the last chunk they touch.
__host__ __device__ __forceinline__ int buffer_bytes(int entries, int size) {
  return (entries * size + 32 + 15) / 16 * 16;
}

// The shared memory of a block: kInStages input stages (in0's buffer, then
// in1's), then kOutStages output buffers, for spans of span_rows rows.
struct Layout {
  int span_rows, in1_offset, in_stage_bytes, out_offset, out_stage_bytes;

  // Rows of n entries for `lanes` lanes a row; inputs of size0 and size1
  // bytes an entry (size1 0: one input), the output of size_out: about
  // kStageBytes of input and output a span, whole passes of the block's
  // warps over rows, spanning at most kMaxSpanUnits units.
  __host__ __device__ static Layout of(int n, int lanes, int size0, int size1, int size_out) {
    const int step = kWarps * (32 / lanes);
    int r = kStageBytes / (n * (size0 + size1 + size_out)) / step * step;
    const int cap = (kMaxSpanUnits - 1) * n / step * step;
    r = r < step ? step : r > cap ? cap : r;
    const int b0 = buffer_bytes(r * n, size0);
    const int in_bytes = b0 + (size1 > 0 ? buffer_bytes(r * n, size1) : 0);
    return Layout{r, b0, in_bytes, kInStages * in_bytes, buffer_bytes(r * n, size_out)};
  }
  __host__ __device__ int bytes() const { return out_offset + kOutStages * out_stage_bytes; }
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)), "r"(1u)
               : "memory");
}

__device__ __forceinline__ void barrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, with the bytes the stage's bulk copies will bring.
__device__ __forceinline__ void barrier_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = shared_address(bar);
  unsigned done = 0u;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(shared_address(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores but the newest `kPending` have read their
// shared memory; all are done.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made visible to the bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where one tensor's span of m entries from entry e0 sits in its staging
// buffer: entry i at byte lead + i·size; the buffer's bytes [from, from +
// bulk) move by one bulk copy, the head entries before them and the tail
// entries after them by the threads.
struct Part {
  int lead, head, tail, from;
  unsigned bulk;

  // The bytes [lo, hi) of device memory by bulk copy, of the span [a, b).
  __device__ __forceinline__ static Part of(unsigned long long a, unsigned long long b,
                                            unsigned long long lo, unsigned long long hi,
                                            int size) {
    const int lead = static_cast<int>(a & 15);
    const int m = static_cast<int>((b - a) / size);
    if (hi <= lo) return Part{lead, m, 0, 0, 0u};
    return Part{lead, lo > a ? static_cast<int>((lo - a) / size) : 0,
                b > hi ? static_cast<int>((b - hi) / size) : 0,
                static_cast<int>(lo - (a - lead)), static_cast<unsigned>(hi - lo)};
  }
  // A load of the span of `base` (a tensor of `total` entries): every chunk
  // the span touches within the tensor.
  __device__ __forceinline__ static Part load(const void* base, long long e0, int m, int size,
                                              long long total) {
    const unsigned long long t0 = reinterpret_cast<unsigned long long>(base);
    const unsigned long long t1 = t0 + static_cast<unsigned long long>(total) * size;
    const unsigned long long a = t0 + static_cast<unsigned long long>(e0) * size;
    const unsigned long long b = a + static_cast<unsigned long long>(m) * size;
    unsigned long long lo = a & ~15ull, hi = (b + 15) & ~15ull;
    if (lo < t0) lo += 16;
    if (hi > t1) hi -= 16;
    return of(a, b, lo, hi, size);
  }
  // A store of the span: the chunks inside it.
  __device__ __forceinline__ static Part store(const void* base, long long e0, int m, int size) {
    const unsigned long long a =
        reinterpret_cast<unsigned long long>(base) + static_cast<unsigned long long>(e0) * size;
    const unsigned long long b = a + static_cast<unsigned long long>(m) * size;
    return of(a, b, (a + 15) & ~15ull, b & ~15ull, size);
  }
  __device__ __forceinline__ int edges() const { return head + tail; }
  // The span's entry of edge i (0 <= i < edges()) out of m.
  __device__ __forceinline__ int edge(int i, int m) const {
    return i < head ? i : m - tail + (i - head);
  }
};

// The bulk copy of one input's span into its buffer `buf` (by the issuing
// thread); `span` is the span's first entry in device memory.
template <typename T>
__device__ __forceinline__ void load_part(unsigned char* buf, const T* span, const Part& p,
                                          unsigned long long* bar) {
  if (p.bulk > 0u)
    bulk_load(buf + p.from, reinterpret_cast<const unsigned char*>(span) - p.lead + p.from,
              p.bulk, bar);
}

// The grid of a launch over `rows` rows: as many blocks as the card holds
// at once (asked once per device and size of shared memory), fewer if there
// are fewer spans.
struct Grid {
  std::atomic<long long> cache{-1};  // shared bytes << 32 | device << 24 | resident blocks

  template <typename K>
  cudaError_t size(K kernel, long long rows, const Layout& L, unsigned& blocks) {
    const int smem = L.bytes();
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const long long key = static_cast<long long>(smem) << 32 | static_cast<long long>(dev) << 24;
    long long c = cache.load(std::memory_order_relaxed);
    if ((c & ~0xffffffLL) != key) {
      int sms = 0, per_sm = 0;
      // all of the SM's shared memory for the kernel, so that the resident
      // blocks the occupancy API counts do fit at once
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem)) != cudaSuccess ||
          (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                               smem)) != cudaSuccess)
        return err;
      c = key | (sms * (per_sm > 0 ? per_sm : 1));
      cache.store(c, std::memory_order_relaxed);
    }
    long long n = (rows + L.span_rows - 1) / L.span_rows;
    if (n > (c & 0xffffffLL)) n = c & 0xffffffLL;
    if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
    blocks = static_cast<unsigned>(n);
    return cudaSuccess;
  }
};

// The (2, n) row masks into shared memory (every thread of the block calls
// it; read after the next barrier).
__device__ __forceinline__ void stage_masks(unsigned long long* staged,
                                            const unsigned long long* __restrict__ masks, int n) {
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) staged[i] = __ldg(masks + i);
}

// Every span of rows of units of n tokens through `rows`: staged input
// spans in0 (T0) and in1 (T1; nullptr: none), the output span out (TO)
// stored back from an output stage. `planes(u0, count)` looks up what the
// rows need of units u0 .. u0 + count - 1 (by the first threads; read after
// a barrier); `rows(s0, s1, so, count, first)` turns the staged spans s0,
// s1 of count rows into the output span so, its row r being row first + r
// of the units from u0. `full`: kInStages mbarriers in shared memory.
template <typename T0, typename T1, typename TO, typename Planes, typename Rows>
__device__ __forceinline__ void staged_spans(const T0* __restrict__ in0,
                                             const T1* __restrict__ in1, TO* __restrict__ out,
                                             long long units, int n, const Layout& L,
                                             unsigned char* smem, unsigned long long* full,
                                             Planes planes, Rows rows) {
  const int tid = threadIdx.x;
  const long long all_rows = units * n, total = all_rows * n;
  const long long spans = (all_rows + L.span_rows - 1) / L.span_rows;
  auto count_of = [&](long long span) {  // the span's rows
    const long long left = all_rows - span * L.span_rows;
    return static_cast<int>(left < L.span_rows ? left : L.span_rows);
  };
  // The bulk copies of span `span` into input stage st (by thread 0).
  auto issue = [&](long long span, int st) {
    const long long e0 = span * L.span_rows * n;
    const int m = count_of(span) * n;
    unsigned char* buf = smem + st * L.in_stage_bytes;
    const Part p0 = Part::load(in0, e0, m, sizeof(T0), total);
    const Part p1 =
        in1 != nullptr ? Part::load(in1, e0, m, sizeof(T1), total) : Part{0, 0, 0, 0, 0u};
    barrier_expect(full + st, p0.bulk + p1.bulk);
    load_part(buf, in0 + e0, p0, full + st);
    if (in1 != nullptr) load_part(buf + L.in1_offset, in1 + e0, p1, full + st);
  };

  if (tid == 0) {
    for (int st = 0; st < kInStages; ++st) barrier_init(full + st);
    barrier_init_fence();
    for (int k = 0; k < kInStages; ++k)
      if (blockIdx.x + k * static_cast<long long>(gridDim.x) < spans)
        issue(blockIdx.x + k * static_cast<long long>(gridDim.x), k);
  }
  __syncthreads();  // the barriers are set
  long long span = blockIdx.x;
  for (int it = 0; span < spans; ++it, span += gridDim.x) {
    const int st = it % kInStages, count = count_of(span), m = count * n;
    const long long r0 = span * L.span_rows, e0 = r0 * n, u0 = r0 / n;
    const int first = static_cast<int>(r0 - u0 * n);
    // plane[] and the edges' entries are free: the last span's rows ended
    // at its second barrier
    planes(u0, (first + count + n - 1) / n);
    unsigned char* in_buf = smem + st * L.in_stage_bytes;
    unsigned char* out_buf = smem + L.out_offset + (it % kOutStages) * L.out_stage_bytes;
    T0* s0;
    T1* s1;
    {
      const Part p0 = Part::load(in0, e0, m, sizeof(T0), total);
      s0 = reinterpret_cast<T0*>(in_buf + p0.lead);
      for (int i = tid; i < p0.edges(); i += blockDim.x)
        s0[p0.edge(i, m)] = in0[e0 + p0.edge(i, m)];
      const Part p1 =
          in1 != nullptr ? Part::load(in1, e0, m, sizeof(T1), total) : Part{0, 0, 0, 0, 0u};
      s1 = reinterpret_cast<T1*>(in_buf + L.in1_offset + p1.lead);
      for (int i = tid; in1 != nullptr && i < p1.edges(); i += blockDim.x)
        s1[p1.edge(i, m)] = in1[e0 + p1.edge(i, m)];
    }
    TO* so = reinterpret_cast<TO*>(
        out_buf + ((reinterpret_cast<unsigned long long>(out) + e0 * sizeof(TO)) & 15));
    barrier_wait(full + st, (it / kInStages) & 1);
    __syncthreads();  // the span, its edges and the planes are in place
    rows(s0, s1, so, count, first);
    fence_async_shared();
    __syncthreads();  // the rows are done: the input stage is free, the output span whole
    const Part po = Part::store(out, e0, m, sizeof(TO));
    if (tid == 0) {
      if (po.bulk > 0u) {
        bulk_store(reinterpret_cast<unsigned char*>(out + e0) - po.lead + po.from,
                   out_buf + po.from, po.bulk);
        bulk_commit();
      }
      const long long next = span + kInStages * static_cast<long long>(gridDim.x);
      if (next < spans) issue(next, st);
      bulk_wait_read<kOutStages - 1>();  // the next span's output stage has left
    }
    for (int i = tid; i < po.edges(); i += blockDim.x) out[e0 + po.edge(i, m)] = so[po.edge(i, m)];
  }
  if (tid == 0) bulk_wait();
}

}  // namespace msoft
