// K2 on Hopper: the block sums of the partition-centric layout.
//
// Replaces pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas_partitioned
// (kernel body _kernel_partitioned) together with the pair -> block
// expansion that follows it in the JAX engine (jax_engine.py:1855-1865).
// The source range is split into K partitions; the slot rows are
// concatenated partition-major and every row belongs to one (dst block,
// source partition) pair, numbered densely in row order. For each pair p
// and lane l
//
//     pair[p*128 + l] = sum over rows r of pair p of
//                       window(part(p))[word(r, l)]
//
// and for each dst block b, in partition order,
//
//     out[b*128 + l] = 0 + pair[p0*128 + l] + pair[p1*128 + l] + ...
//
// over the pairs of b, summed in float. window(k) = z + k*window_stride is
// partition k's slice of the prescaled rank vector (then zeros), stored
// as float or as bf16 (widened exactly). word(r, l) is the partition-LOCAL
// source id of slot (r, l): 3 bytes in planar form (byte plane b of row r
// at src8[r*384 + b*128 + l]) or an int32. Inert slots hold the local
// sentinel (`sentinel`, the span), which reads a zero of the window.
//
// Bound: device-memory bytes: the slot words once (rows*384 bytes, or
// rows*512 as int32), the windows, the plan and the f32 block output.
// Like K1's, the first form was held back by its gathers, and by a second
// pass and the expansion's launches.
//
// What the design does about it: K1's shape (csrc/ell_contrib.cu,
// ell_persistent.cuh), over pairs. One launch a call, persistent CTAs of
// lane groups walking the host's work items (ops/ell.py:pair_plan): first
// each segment of a block whose pairs hold more than kWhole x SEG_ROWS
// rows in all, then each other block whole (the segments of its pairs, in
// partition order, however many short pairs it has), then the empty
// blocks. Each CTA stages the head of
// partition 0's window, which holds the hot sources the in-degree relabel
// puts first; a slot of a partition-0 pair below the head reads it there,
// the sentinel reads no memory, any other slot reads through L1/L2.
// (Restaging per partition would need a CTA-wide barrier between lane
// groups that walk different partitions.) The slot words come by
// L1::no_allocate loads, kBatch rows of gathers in flight a thread while
// the next kBatch rows' words are on their way (3-byte words as one
// 32-bit load a thread and a row, dealt out to the lanes by warp
// shuffles).
//
// The order is the plan's, so the output is bit-identical from run to
// run and equal to the plain plan-order version
// (ops/ell_spmv_partitioned.py:ell_contrib_partitioned_plan_reference): a
// lane sums each segment's rows in row order from 0, a pair's segment
// sums in segment order from 0, and a block's pair sums in partition order
// from 0. A whole block does all of that in one lane group and writes the
// block: no ticket. In a split block a pair of one segment has its sum at
// once; a longer pair is summed by the lane group that draws its last
// ticket (a pair of more than kChunk segments in chunks, then the chunk
// sums in order, as K1's deep blocks; ell_persistent.cuh:finish_group). A
// pair whose block has no other pair writes the block; otherwise it
// writes its pair sum and the lane group that draws the block's last
// ticket sums the block's pairs in partition order from 0 (the host's
// block -> pairs table lists a block's pairs that have rows, in partition
// order; a pair with no rows adds +0.0, which leaves the sum as it was).
// An empty block is written 0. The caller passes the workspace (partial
// and chunk_sum [segs, 128], pair_sum [pairs, 128] float; pair_counter
// [pairs], block_counter [blocks], chunk_counter [segs] int32, zero, left
// zero by each launch) and out [blocks*128]. Each entry point launches on
// the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_persistent.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kLanes;
constexpr int kBatch = 8;
constexpr int kFinish = 16;
constexpr int kChunk = 32;
// A block whose pairs hold at most kWhole segments' rows (kWhole x
// SEG_ROWS) is summed whole by one lane group (the host cuts its work
// items by it: ops/ell.py:WHOLE).
constexpr int kWhole = 4;

template <typename table_t, bool kWords24>
__global__ void __launch_bounds__(kThreads, 1)
ell_contrib_part_kernel(const table_t* __restrict__ z, int64_t window_stride,
                        const void* __restrict__ src,
                        const int32_t* __restrict__ seg_row_start,
                        const int32_t* __restrict__ seg_pair,
                        const int32_t* __restrict__ pair_seg_start,
                        const int32_t* __restrict__ pair_part,
                        const int32_t* __restrict__ pair_block,
                        const int32_t* __restrict__ block_pair_start,
                        const int32_t* __restrict__ block_pairs,
                        const int32_t* __restrict__ item_start,
                        const int32_t* __restrict__ item_segs,
                        const int32_t* __restrict__ empty_blocks,
                        float* __restrict__ partial,
                        float* __restrict__ chunk_sum,
                        float* __restrict__ pair_sum,
                        int32_t* __restrict__ pair_counter,
                        int32_t* __restrict__ block_counter,
                        int32_t* __restrict__ chunk_counter,
                        float* __restrict__ out, int64_t num_items,
                        int64_t num_split, int64_t num_empty,
                        uint32_t sentinel, uint32_t head) {
  __shared__ int tickets[kGroups];
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  table_t* zh = reinterpret_cast<table_t*>(smem);

  ellp::stage_head(zh, z, head, threadIdx.x, kThreads);
  __syncthreads();

  const int64_t first = static_cast<int64_t>(group) * gridDim.x + blockIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  const ellp::SlotStream<kWords24, kBatch> rows{
      static_cast<const unsigned char*>(src)};

  // Segment s's rows summed from 0 into acc, from its pair's window.
  auto segment = [&](int64_t s, int64_t p, float& acc) {
    const int64_t part = pair_part[p];
    rows.sum(acc, seg_row_start[s], seg_row_start[s + 1], lane, zh,
             z + part * window_stride, part == 0 ? head : 0u, sentinel);
  };

  int64_t i = first;
  for (; i < num_items; i += stride) {
    const int64_t k0 = item_start[i], k1 = item_start[i + 1];
    if (i >= num_split) {
      // A whole block: the segments of its pairs, pair by pair in
      // partition order; each pair's segments from 0, the pairs from 0.
      float block_tot = 0.0f, pair_tot = 0.0f;
      int64_t cur = seg_pair[item_segs[k0]];
      for (int64_t k = k0; k < k1; ++k) {
        const int64_t s = item_segs[k];
        const int64_t p = seg_pair[s];
        if (p != cur) {
          block_tot += pair_tot;
          pair_tot = 0.0f;
          cur = p;
        }
        float acc = 0.0f;
        segment(s, p, acc);
        pair_tot += acc;
      }
      block_tot += pair_tot;
      out[static_cast<int64_t>(pair_block[cur]) * kLanes + lane] = block_tot;
      continue;
    }
    // One segment of a block split over lane groups.
    const int64_t s = item_segs[k0];
    const int64_t p = seg_pair[s];
    float val = 0.0f;
    segment(s, p, val);
    const int64_t s0 = pair_seg_start[p], s1 = pair_seg_start[p + 1];
    if (s1 - s0 > 1) {
      partial[s * kLanes + lane] = val;
      if (!ellp::finish_group<kChunk, kFinish>(
              partial, chunk_sum, pair_counter + p, chunk_counter, s, s0, s1,
              tickets + group, group, lane, val))
        continue;
    }
    const int64_t b = pair_block[p];
    const int q0 = block_pair_start[b], q1 = block_pair_start[b + 1];
    if (q1 - q0 == 1) {
      out[b * kLanes + lane] = val;
      continue;
    }
    pair_sum[p * kLanes + lane] = val;
    if (ellp::last_ticket(block_counter + b, q1 - q0, tickets + group, group,
                          lane)) {
      out[b * kLanes + lane] =
          ellp::sum_rows_at<kFinish>(pair_sum, block_pairs, q0, q1, lane);
      if (lane == 0) atomicExch(block_counter + b, 0);
    }
  }
  for (; i < num_items + num_empty; i += stride)
    out[static_cast<int64_t>(empty_blocks[i - num_items]) * kLanes + lane] =
        0.0f;
}

template <typename table_t, bool kWords24>
int launch(const void* z, const void* src, const void* seg_row_start,
           const void* seg_pair, const void* pair_seg_start,
           const void* pair_part, const void* pair_block,
           const void* block_pair_start, const void* block_pairs,
           const void* item_start, const void* item_segs,
           const void* empty_blocks, void* partial, void* chunk_sum,
           void* pair_sum, void* pair_counter, void* block_counter,
           void* chunk_counter, void* out, int64_t window_stride,
           int64_t num_items, int64_t num_split, int64_t num_empty,
           int64_t sentinel, int64_t head, int64_t grid, void* stream) {
  const int64_t smem =
      (head * static_cast<int64_t>(sizeof(table_t)) + 15) / 16 * 16;
  static int64_t opted = 0;  // the bytes this instance may launch with
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_contrib_part_kernel<table_t, kWords24>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  ell_contrib_part_kernel<table_t, kWords24>
      <<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const table_t*>(z), window_stride, src,
          static_cast<const int32_t*>(seg_row_start),
          static_cast<const int32_t*>(seg_pair),
          static_cast<const int32_t*>(pair_seg_start),
          static_cast<const int32_t*>(pair_part),
          static_cast<const int32_t*>(pair_block),
          static_cast<const int32_t*>(block_pair_start),
          static_cast<const int32_t*>(block_pairs),
          static_cast<const int32_t*>(item_start),
          static_cast<const int32_t*>(item_segs),
          static_cast<const int32_t*>(empty_blocks),
          static_cast<float*>(partial), static_cast<float*>(chunk_sum),
          static_cast<float*>(pair_sum), static_cast<int32_t*>(pair_counter),
          static_cast<int32_t*>(block_counter),
          static_cast<int32_t*>(chunk_counter), static_cast<float*>(out),
          num_items, num_split, num_empty, static_cast<uint32_t>(sentinel),
          static_cast<uint32_t>(head));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (table type, slot-word form); float sums always.
// Its arguments come packed in one int64 array, so a call from Python
// converts two values, not twenty-eight: a[0..18] the pointers z, src,
// seg_row_start, seg_pair, pair_seg_start, pair_part, pair_block,
// block_pair_start, block_pairs, item_start, item_segs, empty_blocks,
// partial, chunk_sum, pair_sum, pair_counter, block_counter,
// chunk_counter, out; then window_stride, num_items, num_split,
// num_empty, sentinel, head and grid.
#define PART_ENTRY(NAME, TABLE_T, WORDS24)                                   \
  extern "C" int NAME(const int64_t* a, void* stream) {                      \
    auto p = [a](int i) { return reinterpret_cast<void*>(a[i]); };          \
    return launch<TABLE_T, WORDS24>(                                         \
        p(0), p(1), p(2), p(3), p(4), p(5), p(6), p(7), p(8), p(9), p(10),   \
        p(11), p(12), p(13), p(14), p(15), p(16), p(17), p(18), a[19],       \
        a[20], a[21], a[22], a[23], a[24], a[25], stream);                   \
  }

PART_ENTRY(ell_contrib_part_f32_w24, float, true)
PART_ENTRY(ell_contrib_part_f32_w32, float, false)
PART_ENTRY(ell_contrib_part_bf16_w24, uint16_t, true)
PART_ENTRY(ell_contrib_part_bf16_w32, uint16_t, false)

extern "C" const char* ell_contrib_part_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
