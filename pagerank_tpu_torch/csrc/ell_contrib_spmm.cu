// K1w on Hopper: the blocked-ELL contribution SpMM over k columns at once,
// contrib = A^T_norm * Z for a [n, k] block of prescaled rank columns.
//
// Replaces the JAX op pagerank_tpu/ops/spmv.py:ell_contrib_spmm (called
// from pagerank_tpu/engines/ppr.py:197-216), which gathers one k-wide row
// of a [sz + 1, k] matrix per slot; on the port's PPR path it takes the
// place of K1 launched once per column (ell_contrib.cu). For each dst
// block b, lane l and live column c < kc:
//
//     out[(b*128 + l) * kp + c] = sum over rows r of block b of
//                                 z2[src[r, l] * kp + c]
//
// summed in acc_t (float or double) and written in z_t. z2 is row-major,
// [n_state + 8, kp] (kp: the bound width rounded up to 16-byte rows), the
// columns prescaled by 1/out-degree, with 8 trailing zero rows; inert
// slots hold the sentinel row n_state (`sentinel`). Columns kc..kp-1 are
// neither read nor written. Besides, block 0's 128 lane sums are folded
// pairwise, in acc_t, into row 0 of `fold` [128][kp]: lane l plus lane
// l + h for h = 64, 32, ..., 1 (ops/spmv.py:fold_rows's order). The PPR
// engine puts its dangling vertices in block 0, so that row is each
// column's dangling mass, the same bits alone or in any batch.
//
// Bound: device-memory bytes. The function needs the slot table once
// (rows*128*4 bytes), each column of z2 and of out once and the plan
// (analysis/kernels.py:k1_cost(columns=k)). K1 run once a column read the
// slot table k times, and each of its gathers was a lone 4-byte read: an
// eighth of a 32-byte sector.
//
// What the design does about it.
//  - Whole-sector gathers: a slot's read is a contiguous piece of one z2
//    row, kT columns wide, made of 16-byte vector loads (at f32, kT = 8
//    is one 32-byte sector). A lane of a slot row is kTpl threads, each
//    loading kVpt vectors; a lane group is 128 x kTpl threads.
//  - Column tiles, walked tile-major: the lane groups take the work items
//    of all tiles from one round-robin list, tile 0's first, so one tile
//    of z2 (n x kT columns) can stay in L2 while the items run over it;
//    the slot words are read once a tile (k / kT times), with loads that
//    do not allocate in L1. kT is a compile-time constant; one entry
//    point per (z dtype, sum dtype, kT), and the wrapper picks the tile
//    of a call. On the H100 a 64-column chunk ran fastest as one tile of
//    64 (one pass over the slots, 256-byte row gathers; PERF.md), so the
//    narrower tiles serve calls with fewer live columns. No head of z2
//    is staged in shared memory: a copy of a tile's hot rows measured
//    slower at every tile width (its barrier a tile cost more than it
//    saved; the hot rows stay in L2).
//  - Everything else is K1's: persistent CTAs of kThreads threads, about
//    one per SM; the host's segment plan and work items (ops/ell.py:
//    segment_plan); a batch of rows' gathers issued before their adds,
//    at most kInFlight vectors a thread; a deep block finished by the
//    lane group that draws its last ticket (ell_persistent.cuh:
//    finish_group_n), per tile.
//
// The sums keep K1's order in every column: a lane sums each segment's
// rows in row order from 0 (the sentinel and the rows a last batch runs
// past the segment add +0.0), a whole block's segment sums are added in
// segment order from 0, a deep block's partials chunk by chunk
// (kChunk). So column c is bit-equal to K1 run on column c alone, at
// every kT, and to the plain version (ops/ell_spmm.py:
// ell_contrib_spmm_rows_reference); a column's answer does not depend on
// its batch-mates. The caller passes the workspace (partial and
// chunk_sum [tiles][seg_stride][128][kT] acc_t; counter [tiles][blocks]
// and chunk_counter [tiles][seg_stride] int32, zero, left zero by each
// launch), out and fold. Each entry point launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_persistent.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;
// Lane groups of a CTA at most (a lane group is at least 128 threads):
// one ticket slot each.
constexpr int kMaxGroups = kThreads / kLanes;
constexpr int kVecBytes = 16;
// 16-byte gathers a thread keeps in flight (rows x vectors).
constexpr int kInFlight = 4;
// Partial elements a finisher keeps in flight, and the segments of a
// chunk of a deep block.
constexpr int kFinish = 16;
constexpr int kChunk = 32;
// A block of at most kWhole segments' rows is summed whole by one lane
// group (ops/ell.py:WHOLE).
constexpr int kWhole = 4;

// The geometry of a tile of kT columns of z_t.
template <typename z_t, int kT>
struct Tile {
  static constexpr int kVec = kVecBytes / static_cast<int>(sizeof(z_t));
  static constexpr int kVecs = kT / kVec;  // vectors of a lane's piece
  static constexpr int kTpl =              // threads a lane
      kVecs < kThreads / kLanes ? kVecs : kThreads / kLanes;
  static constexpr int kVpt = kVecs / kTpl;  // vectors a thread
  static constexpr int kGroupThreads = kLanes * kTpl;
  static constexpr int kGroups = kThreads / kGroupThreads;
  // Vectors a thread loads before it adds them (kQ of its kVpt, for
  // kBatch rows).
  static constexpr int kQ = kVpt < kInFlight ? kVpt : kInFlight;
  static constexpr int kBatch = kInFlight / kQ;
  static constexpr int kN = kVpt * kVec;  // sums a thread
  static constexpr int kFinishRows = kFinish / kN > 0 ? kFinish / kN : 1;
  static_assert(kVecs >= 1 && kVecs % kTpl == 0, "a tile of whole vectors");
  static_assert(kVpt % kQ == 0, "whole loads of vectors");
};

template <typename z_t>
__device__ __forceinline__ z_t element(const uint4& v, int e);
template <>
__device__ __forceinline__ float element<float>(const uint4& v, int e) {
  return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ double element<double>(const uint4& v, int e) {
  return e == 0 ? __hiloint2double(static_cast<int>(v.y),
                                   static_cast<int>(v.x))
                : __hiloint2double(static_cast<int>(v.w),
                                   static_cast<int>(v.z));
}

template <typename acc_t>
__device__ __forceinline__ uint4 vector_of(const acc_t* s, float) {
  return make_uint4(__float_as_uint(static_cast<float>(s[0])),
                    __float_as_uint(static_cast<float>(s[1])),
                    __float_as_uint(static_cast<float>(s[2])),
                    __float_as_uint(static_cast<float>(s[3])));
}
template <typename acc_t>
__device__ __forceinline__ uint4 vector_of(const acc_t* s, double) {
  const double a = static_cast<double>(s[0]), b = static_cast<double>(s[1]);
  return make_uint4(static_cast<uint32_t>(__double2loint(a)),
                    static_cast<uint32_t>(__double2hiint(a)),
                    static_cast<uint32_t>(__double2loint(b)),
                    static_cast<uint32_t>(__double2hiint(b)));
}

template <typename z_t, typename acc_t>
struct Params {
  const z_t* z2;
  const int32_t* src;
  const int32_t* seg_row_start;
  const int32_t* seg_block;
  const int32_t* block_seg_start;
  const int32_t* item_start;
  const int32_t* item_segs;
  const int32_t* empty_blocks;
  acc_t* partial;
  acc_t* chunk_sum;
  int32_t* counter;
  int32_t* chunk_counter;
  z_t* out;
  acc_t* fold;
  int64_t num_items, num_split, num_empty;
  uint32_t sentinel;
  int64_t kp, kc, seg_stride, num_blocks;
};

// What one thread does in a tile: the kVpt vectors at columns
// col[q] of the tile, live where the column is below kc.
template <typename z_t, int kT>
struct Slice {
  using G = Tile<z_t, kT>;
  int64_t base;  // the tile's first column
  int col[G::kVpt];
  bool live[G::kVpt];

  __device__ Slice(int64_t tile, int sub, int64_t kc) : base(tile * kT) {
#pragma unroll
    for (int q = 0; q < G::kVpt; ++q) {
      col[q] = (q * G::kTpl + sub) * G::kVec;
      live[q] = base + col[q] < kc;
    }
  }
};

// acc += the kN values of kBatch slot words, in order: the sentinel
// reads no memory and adds +0.0 (a select: the add is still made), any
// other word reads z2 through L1/L2; a vector past the live columns adds
// nothing (its sums stay +0.0). The thread's vectors go kQ at a time:
// the kBatch x kQ gathers of a step are issued before its first add.
template <typename z_t, typename acc_t, int kT>
__device__ __forceinline__ void gather_add(
    acc_t (&acc)[Tile<z_t, kT>::kN], const uint32_t* w, const Slice<z_t, kT>& sl,
    const z_t* z2, int64_t kp, uint32_t sentinel) {
  using G = Tile<z_t, kT>;
#pragma unroll
  for (int q0 = 0; q0 < G::kVpt; q0 += G::kQ) {
    uint4 v[G::kBatch][G::kQ];
#pragma unroll
    for (int j = 0; j < G::kBatch; ++j)
#pragma unroll
      for (int q = 0; q < G::kQ; ++q) {
        v[j][q] = make_uint4(0u, 0u, 0u, 0u);
        if (sl.live[q0 + q] && w[j] != sentinel)
          v[j][q] = __ldg(reinterpret_cast<const uint4*>(
              z2 + static_cast<int64_t>(w[j]) * kp + sl.base + sl.col[q0 + q]));
      }
#pragma unroll
    for (int j = 0; j < G::kBatch; ++j)
#pragma unroll
      for (int q = 0; q < G::kQ; ++q)
        if (sl.live[q0 + q])
#pragma unroll
          for (int e = 0; e < G::kVec; ++e)
            acc[(q0 + q) * G::kVec + e] +=
                static_cast<acc_t>(element<z_t>(v[j][q], e));
  }
}

// acc = the sums of slot rows [r0, r1) in row order, from 0.
template <typename z_t, typename acc_t, int kT>
__device__ __forceinline__ void sum_segment(
    acc_t (&acc)[Tile<z_t, kT>::kN], const Params<z_t, acc_t>& p, int64_t r0,
    int64_t r1, int lane, const Slice<z_t, kT>& sl) {
  using G = Tile<z_t, kT>;
  const ellp::SlotStream<false, G::kBatch> rows{
      reinterpret_cast<const unsigned char*>(p.src)};
#pragma unroll
  for (int e = 0; e < G::kN; ++e) acc[e] = acc_t(0);
  uint32_t raw[G::kBatch];
  rows.next(r0, r1, lane, raw);
  for (int64_t r = r0; r < r1; r += G::kBatch) {
    uint32_t w[G::kBatch];
    rows.decode(raw, r, r1, lane, p.sentinel, w);
    if (r + G::kBatch < r1) rows.next(r + G::kBatch, r1, lane, raw);
    gather_add<z_t, acc_t, kT>(acc, w, sl, p.z2, p.kp, p.sentinel);
  }
}

// Block 0's lane sums folded into row 0 of p.fold (this tile's live
// columns): level h = 64, 32, ..., 1 adds lane l + h to lane l for l < h,
// after a barrier of the lane group; a lane stores what a later level
// reads, through L2 (st.cg / ld.cg).
template <typename z_t, typename acc_t, int kT>
__device__ __forceinline__ void fold_lanes(const Params<z_t, acc_t>& p,
                                           int lane, const Slice<z_t, kT>& sl,
                                           acc_t (&tot)[Tile<z_t, kT>::kN],
                                           int group) {
  using G = Tile<z_t, kT>;
  acc_t* f = p.fold + sl.base;
  for (int h = kLanes; h > 1; h /= 2) {
    if (lane >= h / 2 && lane < h)
#pragma unroll
      for (int q = 0; q < G::kVpt; ++q)
        if (sl.live[q])
#pragma unroll
          for (int e = 0; e < G::kVec; ++e)
            __stcg(f + lane * p.kp + sl.col[q] + e, tot[q * G::kVec + e]);
    ellp::group_sync_n(group, G::kGroupThreads);
    if (lane < h / 2)
#pragma unroll
      for (int q = 0; q < G::kVpt; ++q)
        if (sl.live[q])
#pragma unroll
          for (int e = 0; e < G::kVec; ++e)
            tot[q * G::kVec + e] +=
                __ldcg(f + (lane + h / 2) * p.kp + sl.col[q] + e);
  }
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < G::kVpt; ++q)
      if (sl.live[q])
#pragma unroll
        for (int e = 0; e < G::kVec; ++e)
          f[sl.col[q] + e] = tot[q * G::kVec + e];
}

// Write a thread's live vectors of row b*128 + lane; block 0's lane
// group then folds its lanes. Every thread of the lane group calls it.
template <typename z_t, typename acc_t, int kT>
__device__ __forceinline__ void store_row(const Params<z_t, acc_t>& p,
                                          int64_t b, int lane,
                                          const Slice<z_t, kT>& sl,
                                          acc_t (&tot)[Tile<z_t, kT>::kN],
                                          int group) {
  using G = Tile<z_t, kT>;
  z_t* row = p.out + (b * kLanes + lane) * p.kp + sl.base;
#pragma unroll
  for (int q = 0; q < G::kVpt; ++q)
    if (sl.live[q])
      *reinterpret_cast<uint4*>(row + sl.col[q]) =
          vector_of(tot + q * G::kVec, z_t());
  if (b == 0) fold_lanes<z_t, acc_t, kT>(p, lane, sl, tot, group);
}

// Work item i of tile `tile`: a whole block, one segment of a deep block
// (and, for the lane group that draws the block's last ticket, the
// block), or an empty block.
template <typename z_t, typename acc_t, int kT>
__device__ __forceinline__ void run_item(const Params<z_t, acc_t>& p,
                                         int64_t i, int64_t tile, int* slot,
                                         int group, int tid) {
  using G = Tile<z_t, kT>;
  const int lane = tid / G::kTpl;
  const Slice<z_t, kT> sl(tile, tid % G::kTpl, p.kc);
  acc_t tot[G::kN];
  if (i >= p.num_items) {
#pragma unroll
    for (int e = 0; e < G::kN; ++e) tot[e] = acc_t(0);
    store_row<z_t, acc_t, kT>(p, p.empty_blocks[i - p.num_items], lane, sl,
                              tot, group);
    return;
  }
  const int64_t k0 = p.item_start[i], k1 = p.item_start[i + 1];
  const int64_t b = p.seg_block[p.item_segs[k0]];
  acc_t acc[G::kN];
  if (i >= p.num_split) {
    // A whole block: its segments, each from 0, added in order from 0.
#pragma unroll
    for (int e = 0; e < G::kN; ++e) tot[e] = acc_t(0);
    for (int64_t k = k0; k < k1; ++k) {
      const int64_t s = p.item_segs[k];
      sum_segment<z_t, acc_t, kT>(acc, p, p.seg_row_start[s],
                                  p.seg_row_start[s + 1], lane, sl);
#pragma unroll
      for (int e = 0; e < G::kN; ++e) tot[e] += acc[e];
    }
    store_row<z_t, acc_t, kT>(p, b, lane, sl, tot, group);
    return;
  }
  // One segment of a deep block: its partial in this tile's workspace,
  // then the block's tickets.
  const int64_t s = p.item_segs[k0];
  sum_segment<z_t, acc_t, kT>(acc, p, p.seg_row_start[s],
                              p.seg_row_start[s + 1], lane, sl);
  constexpr int64_t kRow = static_cast<int64_t>(kLanes) * kT;
  const int64_t ws = tile * p.seg_stride * kRow;
  int off[G::kN];
#pragma unroll
  for (int q = 0; q < G::kVpt; ++q)
#pragma unroll
    for (int e = 0; e < G::kVec; ++e)
      off[q * G::kVec + e] = lane * kT + sl.col[q] + e;
#pragma unroll
  for (int e = 0; e < G::kN; ++e) p.partial[ws + s * kRow + off[e]] = acc[e];
  if (ellp::finish_group_n<kChunk, G::kFinishRows>(
          p.partial + ws, p.chunk_sum + ws,
          p.counter + tile * p.num_blocks + b,
          p.chunk_counter + tile * p.seg_stride, s, p.block_seg_start[b],
          p.block_seg_start[b + 1], slot, group, tid, G::kGroupThreads, kRow,
          off, tot))
    store_row<z_t, acc_t, kT>(p, b, lane, sl, tot, group);
}

// Each lane group takes items first, first + stride, ... of the
// tile-major list (tiles x items): tile 0's items, then tile 1's.
template <typename z_t, typename acc_t, int kT>
__global__ void __launch_bounds__(kThreads, 1)
ell_contrib_spmm_kernel(const __grid_constant__ Params<z_t, acc_t> p) {
  using G = Tile<z_t, kT>;
  __shared__ int tickets[kMaxGroups];
  const int group = threadIdx.x / G::kGroupThreads;
  const int tid = threadIdx.x % G::kGroupThreads;
  const int64_t items = p.num_items + p.num_empty;
  const int64_t tiles = (p.kc + kT - 1) / kT;
  const int64_t first = static_cast<int64_t>(group) * gridDim.x + blockIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * G::kGroups;
  for (int64_t i = first; i < tiles * items; i += stride)
    run_item<z_t, acc_t, kT>(p, i % items, i / items, tickets + group, group,
                             tid);
}

template <typename z_t, typename acc_t, int kT>
int launch(const int64_t* a, void* stream) {
  auto ptr = [a](int i) { return reinterpret_cast<void*>(a[i]); };
  Params<z_t, acc_t> p;
  p.z2 = static_cast<const z_t*>(ptr(0));
  p.src = static_cast<const int32_t*>(ptr(1));
  p.seg_row_start = static_cast<const int32_t*>(ptr(2));
  p.seg_block = static_cast<const int32_t*>(ptr(3));
  p.block_seg_start = static_cast<const int32_t*>(ptr(4));
  p.item_start = static_cast<const int32_t*>(ptr(5));
  p.item_segs = static_cast<const int32_t*>(ptr(6));
  p.empty_blocks = static_cast<const int32_t*>(ptr(7));
  p.partial = static_cast<acc_t*>(ptr(8));
  p.chunk_sum = static_cast<acc_t*>(ptr(9));
  p.counter = static_cast<int32_t*>(ptr(10));
  p.chunk_counter = static_cast<int32_t*>(ptr(11));
  p.out = static_cast<z_t*>(ptr(12));
  p.fold = static_cast<acc_t*>(ptr(13));
  p.num_items = a[14];
  p.num_split = a[15];
  p.num_empty = a[16];
  p.sentinel = static_cast<uint32_t>(a[17]);
  const int64_t grid = a[18];
  p.kp = a[19];
  p.kc = a[20];
  p.seg_stride = a[21];
  p.num_blocks = a[22];
  ell_contrib_spmm_kernel<z_t, acc_t, kT>
      <<<static_cast<unsigned>(grid), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (z dtype, sum dtype, tile width kT):
// ell_contrib_spmm_<z>_<acc>_kt<kT>. Its arguments come packed in one
// int64 array: a[0..13] the pointers z2, src, seg_row_start, seg_block,
// block_seg_start, item_start, item_segs, empty_blocks, partial,
// chunk_sum, counter, chunk_counter, out, fold; then num_items,
// num_split, num_empty, sentinel, grid, kp, kc, seg_stride and
// num_blocks.
#define K1W_ENTRY(Z, ACC, Z_T, ACC_T, KT)                                \
  extern "C" int ell_contrib_spmm_##Z##_##ACC##_kt##KT(const int64_t* a, \
                                                       void* stream) {   \
    return launch<Z_T, ACC_T, KT>(a, stream);                            \
  }
#define K1W_TILES(Z, ACC, Z_T, ACC_T)  \
  K1W_ENTRY(Z, ACC, Z_T, ACC_T, 4)     \
  K1W_ENTRY(Z, ACC, Z_T, ACC_T, 8)     \
  K1W_ENTRY(Z, ACC, Z_T, ACC_T, 16)    \
  K1W_ENTRY(Z, ACC, Z_T, ACC_T, 32)    \
  K1W_ENTRY(Z, ACC, Z_T, ACC_T, 64)

K1W_TILES(f32, f32, float, float)
K1W_TILES(f32, f64, float, double)
K1W_TILES(f64, f64, double, double)

extern "C" const char* ell_contrib_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
