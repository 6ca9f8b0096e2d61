// Fused adjacency-masked window attention, forward, read and written in the
// TPU layouts of the kernel bench, for Hopper (sm_90a).
//
// Replaces the layout twins of sl_hwgat_tpu/ops/pallas_attention.py::_fwd_kernel
// as the bench drives them: _fwd_kernel_t (:356), _fwd_kernel_ts (:676),
// _fwd_kernel_ts_batched (:447), _fwd_kernel_wide (:489),
// _fwd_kernel_wide_batched (:571), and the fused probes of bench_kernel.py
// (:515 tlay_fused, :593 mix_fused, :685 tmx_fused, :805 tmq_fused,
// :951 tsw_*, :1012 lp_fused_bf16). It computes K1's function
// (window_attention_fwd.cu) on 32-token units with DH 64, without moving any
// operand into the token-major layout first.
//
// Every layout is a strided view of 32-token units, a token's features
// contiguous ("rows") or a feature's tokens ("columns"), as
// window_attention_layout.cuh describes; q, k, v and o each come with their
// own view (ops/window_attention.py::window_attention_into builds them).
//
// Bound on an H100 SXM: bytes, as K1's. A call reads q, k, v and writes o
// once: 201 MB in bf16 at the bench's 12288 units, 60 us at 3.35 TB/s.
// Before this kernel the bench moved each operand to token-major and back
// with the relayout kernel: up to four transposes of 50 MB around K1, each
// about as long as K1 itself.
//
// Design: K1's at 32 tokens (a warp per unit, 4 a block, the warp's own
// shared memory, no block-wide barriers); the arithmetic is K1's, in K1's
// order, so o equals K1's output on the permuted inputs bit for bit. The
// steps the two share live in window_attention_wide.cuh (stage_unit,
// stage_keys, attend_strips, store_unit_rows):
//   - rows operands are staged as K1 stages them (cp.async 16-byte rows,
//     here with a source row stride; bf16 k by 16-byte loads to f32 rows);
//   - columns operands are staged by cp.async as DH rows of 32 tokens (64 B
//     in bf16, 128 B in f32: 4 or 8 16-byte chunks), rows padded by 16
//     bytes. Lane i reads token i of every row of q: its query row straight
//     into registers. k becomes the f32 rows that attention_row reads: in
//     bf16 in place (staged at the start of their space, read as token
//     pairs), in f32 from its own space; each lane starts at another
//     4-feature chunk, so the reads and the 16-byte writes meet no bank
//     conflicts;
//   - scores, prune, mask and softmax: attention_row
//     (window_attention_common.cuh), as K1;
//   - A V: bf16 on mma.sync m16n8k16 with T(A) by ldmatrix; V from rows by
//     ldmatrix.trans, as K1, or from columns (V^T) by ldmatrix, which gives
//     the same B fragments. f32: V columns become f32 rows, then K1's 4 x 8
//     register tiles over a swizzled T(A);
//   - o out through the warp's shared memory with 16-byte stores, along its
//     rows (K1's padded O tile, with a row stride) or along tokens (in bf16
//     a padded O^T tile written by stmatrix .trans from the accumulators;
//     in f32 a 32-float O^T tile whose 16-byte chunks are swizzled by the
//     feature's quad, so that both the register-tile writes and the 16-byte
//     reads meet no bank conflicts).
// Instantiations: the (operand form, type) sets that the bench's probes
// use: every operand in columns (f32 and bf16: tlay, tmq, tsw, the pallas_t*
// entries, pair_tscore), q in rows (mix), q and k in rows (tmx), every one
// in rows (lp, and token-major units).

#include "window_attention_layout.cuh"

namespace {

using namespace wattn;
using namespace wattn::layout;

constexpr int kWarps = 4;         // 32-token units a block, one a warp
constexpr int kRows = 0, kCols = 1;  // an operand's form

// q rows and bf16 v rows padded by 16 bytes (K1's); f32 v rows DH apart
template <typename T> constexpr int kPad = wide::kUnitPad<T, kDH>;
template <typename T> constexpr int kVStride = std::is_same<T, float>::value ? kDH : kPad<T>;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Blocks an SM, at least: bf16 at 4 (128 registers, no spills; its
// transposed form took 158 without the bound and ran 4-9% slower, bench.ablate
// layout), f32 unbounded (at 128 registers it spilled, and its 26 KB of
// shared memory a warp allow 2 blocks an SM anyway).
template <typename T> constexpr int kMinBlocks = std::is_same<T, float>::value ? 1 : 4;

// One warp's shared memory, bytes: K as f32 rows (bf16: k's columns first;
// then T(A), then O), q then v, and in f32 k's columns, then V as f32 rows.
template <typename T, int QF, int KF, int VF, int OF>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kKs = kN * kDH * 4;
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kQ = QF == kRows ? kN * kPad<T> * kSize : kColBytes<T>;
  static constexpr int kV = VF == kRows ? kN * kVStride<T> * kSize : kColBytes<T>;
  // f32 O^T takes v's space once V is in rows
  static constexpr int kQv = cmax(cmax(kQ, kV), kF32 && OF == kCols ? kN * kDH * 4 : 0);
  static constexpr int kKst = kF32 ? cmax(KF == kCols ? kColBytes<T> : 0,
                                          VF == kCols ? kN * kDH * 4 : 0) : 0;
  static constexpr int kWarp = kKs + kQv + kKst;
  static constexpr int kBlock = kWarps * kWarp;
  static_assert(kColBytes<bf16> <= kKs, "bf16 k columns are staged in K's rows' space");
};

struct Views {
  View q, k, v, o;
};

// Staged f32 columns -> f32 rows DH apart: lane i writes row i, one
// 4-feature chunk a step, starting at chunk i (mod DH / 4). The reads of a
// step then fall in 32 distinct banks (rows 16 bytes longer than the
// tokens), and every 8 lanes write 8 distinct 16-byte bank groups.
__device__ __forceinline__ void cols_to_rows(const float* cols, float* rows, int lane) {
  constexpr int kQuads = kDH / 4;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int d = 4 * ((i + lane) % kQuads);
    const float* s = cols + d * kSP<float> + lane;
    *reinterpret_cast<float4*>(rows + lane * kDH + d) =
        make_float4(s[0], s[kSP<float>], s[2 * kSP<float>], s[3 * kSP<float>]);
  }
}

// A V for a unit in bf16, then o out (K1's bf16 attend_values, V and o in
// either form): wide::attend_strips (V's B fragments from its rows or from
// V^T's), then O through the warp's shared memory (over K's rows), out in
// 16-byte chunks along o's rows (wide::store_unit_rows, K1's) or tokens.
template <int VF, int OF, typename TO>
__device__ __forceinline__ void attend_values(const float (&e)[kN], float sum, float* kspace,
                                              const bf16* vt, TO* __restrict__ out, long long ld,
                                              int lane) {
  float acc[2][kDH / 8][4];
  wide::attend_strips<kDH, VF == kRows ? kPad<bf16> : kSP<bf16>, VF == kCols>(
      e, sum, reinterpret_cast<bf16*>(kspace), vt, lane, acc);
  constexpr int kE = kEpc<TO>;
  TO* os = reinterpret_cast<TO*>(kspace);
  if constexpr (OF == kRows) {
    wide::store_unit_rows<kDH>(acc, os, out, ld, lane);
  } else {
    static_assert(sizeof(TO) == 2, "O^T through a padded tile in bf16 (f32: the swizzled one)");
    constexpr int kOS = kSP<TO>;  // O^T rows: 32 tokens and 16 bytes of padding
    // four 8 x 8 blocks of the accumulator layout a store, transposed:
    // (rows 0-7, 8-15) x (columns 8j .. 8j + 7, 8j + 8 .. 8j + 15); lanes
    // 8i .. 8i + 7 give the O^T rows of block i
    const int blk = lane >> 3, r = lane & 7;
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int j = 0; j < kDH / 8; j += 2)
        stsm_x4_trans(os + (8 * (j + (blk >> 1)) + r) * kOS + 16 * st + 8 * (blk & 1),
                      wide::pack_bf16(acc[st][j][0], acc[st][j][1]),
                      wide::pack_bf16(acc[st][j][2], acc[st][j][3]),
                      wide::pack_bf16(acc[st][j + 1][0], acc[st][j + 1][1]),
                      wide::pack_bf16(acc[st][j + 1][2], acc[st][j + 1][3]));
    __syncwarp();
    // 4 chunks a feature row; the 8 lanes of a quarter warp read rows d and
    // d + 4 (64 words apart: distinct banks)
    constexpr int kChunks = kN / kE;
#pragma unroll
    for (int i = 0; i < kDH * kChunks / 32; ++i) {
      const int idx = lane / kChunks;
      const int d = 8 * i + (idx >> 1) + 4 * (idx & 1), x = lane % kChunks * kE;
      *reinterpret_cast<uint4*>(out + d * ld + x) =
          *reinterpret_cast<const uint4*>(os + d * kOS + x);
    }
  }
}

// O^T tile of f32: feature d's 16-byte chunk c (tokens 4c .. 4c + 3) sits
// at chunk c ^ (d / 4 % 8) of its 32-float row.
__device__ __forceinline__ int swizzled_t(int d, int token) {
  return d * kN + ((((token >> 2) ^ (d >> 2)) & 7) << 2) + (token & 3);
}

// A V for a unit in f32 with V and o in columns: T(A) into the swizzled
// 32 x 32 tile over K's rows (K1's), V's columns into f32 rows over k's
// columns, two 16-row strips of 4 x 8 register tiles (K1's tile_product_of:
// sums over j ascending from 0), O^T through v's space, out in 16-byte
// chunks along tokens.
__device__ __forceinline__ void attend_values_f32(const float (&e)[kN], float sum, float* kspace,
                                                  float* vcols, float* vrows,
                                                  float* __restrict__ out, long long ld, int lane) {
  float* at = kspace;
#pragma unroll
  for (int c = 0; c < kN; c += 4)
    *reinterpret_cast<float4*>(at + wide::Swizzled32::at(lane, c)) =
        make_float4(e[c] / sum, e[c + 1] / sum, e[c + 2] / sum, e[c + 3] / sum);
  cols_to_rows(vcols, vrows, lane);
  __syncwarp();  // T(A) and V's rows in place; v's columns are dead
  float* ot = vcols;
  constexpr int kHalves = kDH / 32;
  const int cg = lane & 7;
  float acc[4][4 * kHalves];
#pragma unroll 1
  for (int r0 = 0; r0 < kN; r0 += 16) {
    wide::tile_product_of<false, kN, kHalves>(wide::Swizzled32{at}, wide::Shared<kDH>{vrows}, r0,
                                              lane, acc);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int c = 0; c < 4 * kHalves; ++c)
        ot[swizzled_t(32 * (c / 4) + 4 * cg + c % 4, r0 + wide::tile_row<false>(lane, ii))] =
            acc[ii][c];
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < kDH * 8; c += 32) {  // 8 chunks a feature row, a row per 8 lanes
    const int d = c >> 3, p = c & 7;
    *reinterpret_cast<float4*>(out + d * ld + 4 * ((p ^ (d >> 2)) & 7)) =
        *reinterpret_cast<const float4*>(ot + d * kN + 4 * p);
  }
}

template <typename T, typename TO, int QF, int KF, int VF, int OF>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks<T>)
window_attention_layout_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, TO* __restrict__ o, const Views views,
                               const uint32_t* __restrict__ masks, const int* __restrict__ sel,
                               const float* __restrict__ prune_u, long long units, float scale,
                               int zero_quirk, int dual, int stack, int per_group, int groups,
                               long long unit_offset) {
  using M = Smem<T, QF, KF, VF, OF>;
  extern __shared__ __align__(16) unsigned char layout_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long unit = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (unit >= units) return;
  unsigned char* mine = layout_smem + warp * M::kWarp;
  float* ks = reinterpret_cast<float*>(mine);
  T* qv = reinterpret_cast<T*>(mine + M::kKs);  // q, then v (once the query rows are in registers)
  T* kst = reinterpret_cast<T*>(mine + M::kKs + M::kQv);

  const T* qb = q + unit_base(views.q, unit);
  if constexpr (QF == kRows) wide::stage_unit<T, kDH, kPad<T>>(qb, qv, lane, views.q.ld);
  else stage_cols(qb, views.q.ld, qv, lane);
  constexpr bool kF32 = std::is_same<T, float>::value;
  const T* kb = k + unit_base(views.k, unit);
  if constexpr (KF == kRows) wide::stage_keys<kDH>(kb, ks, lane, views.k.ld);
  else stage_cols(kb, views.k.ld, kF32 ? kst : reinterpret_cast<T*>(ks), lane);
  wide::cp_async_wait_all();
  __syncwarp();
  if constexpr (KF == kCols && kF32) cols_to_rows(kst, ks, lane);
  else if constexpr (KF == kCols) key_cols_to_rows(ks, ks, lane);

  // Scores, prune, mask and softmax of row `lane`; K rows are broadcast reads.
  float e[kN], sum;
  {
    float qr[kDH];
    if constexpr (QF == kRows) load_scaled_row<T, kDH>(qv + lane * kPad<T>, scale, qr);
    else load_scaled_col(qv, scale, qr, lane);
    __syncwarp();  // every query row in registers, every K row written: v takes q's space
    const T* vb = v + unit_base(views.v, unit);
    if constexpr (VF == kRows) wide::stage_unit<T, kDH, kVStride<T>>(vb, qv, lane, views.v.ld);
    else stage_cols(vb, views.v.ld, qv, lane);
    const auto allowed_row = [&] {
      return masks[mask_plane(unit, dual, sel, stack, per_group, groups, unit_offset) * kN + lane];
    };
    attention_row<kN, kDH>(qr, ks, kN, prune_u, allowed_row, zero_quirk, e, sum);
  }
  wide::cp_async_wait_all();
  __syncwarp();  // K is dead and V in place in every lane
  TO* out = o + unit_base(views.o, unit);
  if constexpr (kF32) {
    static_assert(VF == kCols && OF == kCols && std::is_same<TO, float>::value,
                  "f32: every operand in columns");
    attend_values_f32(e, sum, ks, qv, reinterpret_cast<float*>(kst), out, views.o.ld, lane);
  } else {
    attend_values<VF, OF>(e, sum, ks, qv, out, views.o.ld, lane);
  }
}

struct Args {
  const void* q; const void* k; const void* v; void* o; Views views;
  const void* masks; const int* sel; const float* prune_u;
  long long units; float scale; int zero_quirk; int dual; int stack;
  int per_group; int groups; long long unit_offset; cudaStream_t stream;
};

template <typename T, typename TO, int QF, int KF, int VF, int OF>
cudaError_t launch(const Args& a) {
  constexpr int kBytes = Smem<T, QF, KF, VF, OF>::kBlock;
  const long long blocks = (a.units + kWarps - 1) / kWarps;
  const auto kernel = window_attention_layout_kernel<T, TO, QF, KF, VF, OF>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<TO*>(a.o), a.views, static_cast<const uint32_t*>(a.masks), a.sel, a.prune_u,
      a.units, a.scale, a.zero_quirk, a.dual, a.stack, a.per_group, a.groups, a.unit_offset);
  return cudaGetLastError();
}

// forms: bit 0 q, 1 k, 2 v, 3 o; 1 = columns
constexpr int kAllCols = 0xf, kQRows = 0xe, kQKRows = 0xc, kAllRows = 0x0;

// One block's dynamic shared memory for (dtype, forms), or -1 where there
// is no instantiation.
int block_bytes(int dtype, int forms) {
  if (dtype == 0) return forms == kAllCols ? Smem<float, 1, 1, 1, 1>::kBlock : -1;
  if (dtype != 1) return -1;
  switch (forms) {
    case kAllCols: return Smem<bf16, 1, 1, 1, 1>::kBlock;
    case kQRows: return Smem<bf16, 0, 1, 1, 1>::kBlock;
    case kQKRows: return Smem<bf16, 0, 0, 1, 1>::kBlock;
    case kAllRows: return Smem<bf16, 0, 0, 0, 0>::kBlock;
    default: return -1;
  }
}

}  // namespace

// q, k, v, o: device pointers; views: host array of 4 x (sa, sb, ss, ld, nb,
// ns), in elements, for q, k, v, o; dtype codes 0 = float32, 1 = bfloat16
// (f32 in, f32 out, or bf16 in, bf16 out); forms: bit 0 q, 1 k, 2 v, 3 o,
// 1 = columns (f32: all four; bf16: all four, all but q, v and o, or none);
// masks: (2, 32) 32-bit row bitmasks. Returns a cudaError_t (0 = launched).
extern "C" int window_attention_layout(const void* q, const void* k, const void* v, void* o,
                                       const void* views, const void* masks, const void* sel,
                                       const void* prune_u, long long units, int dh,
                                       int in_dtype, int out_dtype, int forms, float scale,
                                       int zero_quirk, int dual, int stack, int per_group,
                                       int groups, long long unit_offset, void* stream) {
  if (units <= 0 || units > 0x7fffffffLL || stack <= 0 || dh != kDH || in_dtype != out_dtype ||
      block_bytes(in_dtype, forms) < 0 ||
      (dual && sel == nullptr && (per_group <= 0 || groups <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* w = static_cast<const long long*>(views);
  View vs[4];
  for (int i = 0; i < 4; ++i) {
    const long long* x = w + 6 * i;
    if (x[4] <= 0 || x[5] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    vs[i] = View{x[0], x[1], x[2], x[3], static_cast<int>(x[4]), static_cast<int>(x[5])};
  }
  const Args a{q, k, v, o, Views{vs[0], vs[1], vs[2], vs[3]}, masks,
               static_cast<const int*>(sel), static_cast<const float*>(prune_u), units, scale,
               zero_quirk, dual, stack, per_group, groups, unit_offset,
               static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0) return static_cast<int>(launch<float, float, 1, 1, 1, 1>(a));
  switch (forms) {
    case kAllCols: return static_cast<int>(launch<bf16, bf16, 1, 1, 1, 1>(a));
    case kQRows: return static_cast<int>(launch<bf16, bf16, 0, 1, 1, 1>(a));
    case kQKRows: return static_cast<int>(launch<bf16, bf16, 0, 0, 1, 1>(a));
    default: return static_cast<int>(launch<bf16, bf16, 0, 0, 0, 0>(a));
  }
}

// The dynamic shared memory (bytes) and threads of one block for dtype code
// `dtype` and `forms`. Returns a cudaError_t.
extern "C" int window_attention_layout_block(int dtype, int forms, int* smem, int* threads) {
  const int bytes = block_bytes(dtype, forms);
  if (bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  *smem = bytes;
  *threads = kWarps * 32;
  return 0;
}
