// K1 on Hopper: the blocked-ELL contribution SpMV, contrib = A^T_norm * r.
//
// Replaces pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas (kernel body
// _kernel). For each dst block b and lane l:
//
//     out[b*128 + l] = sum over rows r of block b of z_ext[src[r, l]]
//
// summed in acc_t (float or double) and written in z_t. z_ext is the rank
// vector prescaled by 1/out-degree with 8 trailing zeros; inert slots hold
// the sentinel index n_state (`sentinel`).
//
// Bound: device-memory bytes. Each step must stream the whole slot table
// (rows*128*4 bytes) once, plus z (n_pad*sizeof(z_t)), the output and the
// plan; at 3.35 TB/s that is the least time the card can take. What held
// the first (two-pass) form far from it was the gathers: one divergent L1
// access per slot, near one a clock per SM, with the slot words streaming
// through the same L1 and evicting the z lines that are read again.
//
// What the design does about it. One launch a call: persistent CTAs of
// kThreads threads (about one per SM; the grid is the wrapper's), each
// cut into lane groups of 128 threads, one thread per lane. Work items
// come from the host (ops/ell.py:segment_plan): first each segment of a
// block longer than kWhole segments of SEG_ROWS rows (the hubs the
// in-degree relabel puts first), then each other block whole (its
// segments, at most kWhole x SEG_ROWS rows), then the empty blocks; item i goes to CTA
// i % grid, lane group (i / grid) % kGroups, so the hubs spread over
// every SM. Each CTA first copies the hot head z_ext[0:head] into shared
// memory (the relabel puts the hot sources first): a slot below the head
// reads it there, the sentinel reads no memory (it adds +0.0), any other
// slot reads through L1/L2. The slot words are read with loads that do
// not allocate in L1; a thread issues kBatch rows' gathers before it adds
// them, in row order, while the next kBatch rows' words are already on
// their way. (A ring of 1-D bulk copies in shared memory in place of
// those loads was measured slower on the H100, and left out: PERF.md.)
//
// The sums keep the plan's order, so the output is bit-identical from run
// to run and equal to the plain plan-order version
// (ops/ell_spmv.py:ell_contrib_plan_reference): a lane sums each segment's
// rows in row order from 0 (the rows a last batch runs past the segment
// add +0.0, which leaves every sum that starts at +0.0 as it was), and a
// block's segment sums are added in segment order from 0. A whole block
// does that in one lane group and writes the block: no ticket. A deep
// block's segments write their partials, and the lane group that draws
// the block's last ticket sums them and resets the counter; a block of
// more than kChunk segments is summed in chunks of kChunk segments, then
// the chunk sums in order (ell_persistent.cuh:finish_group), so the hub's
// finisher sums some hundred rows, not its thousands of segments. An
// empty block is written 0. The caller passes the workspace (partial and
// chunk_sum [segs, 128] acc_t; counter [blocks], chunk_counter [segs]
// int32, zero, left zero by each launch) and out [blocks*128]. Each entry
// point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_persistent.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;
constexpr int kGroups = kThreads / kLanes;
// Rows a thread keeps in flight.
constexpr int kBatch = 8;
// Partials a finisher keeps in flight, and the segments of a chunk of a
// deep block (ell_persistent.cuh:finish_group).
constexpr int kFinish = 16;
constexpr int kChunk = 32;
// A block of at most kWhole segments' rows (kWhole x SEG_ROWS) is summed
// whole by one lane group (the host cuts its work items by it:
// ops/ell.py:WHOLE).
constexpr int kWhole = 4;

template <typename z_t, typename acc_t>
__global__ void __launch_bounds__(kThreads, 1)
ell_contrib_kernel(const z_t* __restrict__ z_ext,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ seg_row_start,
                   const int32_t* __restrict__ seg_block,
                   const int32_t* __restrict__ block_seg_start,
                   const int32_t* __restrict__ item_start,
                   const int32_t* __restrict__ item_segs,
                   const int32_t* __restrict__ empty_blocks,
                   acc_t* __restrict__ partial, acc_t* __restrict__ chunk_sum,
                   int32_t* __restrict__ counter,
                   int32_t* __restrict__ chunk_counter, z_t* __restrict__ out,
                   int64_t num_items, int64_t num_split, int64_t num_empty,
                   uint32_t sentinel, uint32_t head) {
  __shared__ int tickets[kGroups];
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  z_t* zh = reinterpret_cast<z_t*>(smem);

  ellp::stage_head(zh, z_ext, head, threadIdx.x, kThreads);
  __syncthreads();

  const int64_t first = static_cast<int64_t>(group) * gridDim.x + blockIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  const ellp::SlotStream<false, kBatch> rows{
      reinterpret_cast<const unsigned char*>(src)};

  int64_t i = first;
  for (; i < num_items; i += stride) {
    const int64_t k0 = item_start[i], k1 = item_start[i + 1];
    const int64_t b = seg_block[item_segs[k0]];
    if (i >= num_split) {
      // A whole block: its segments, each from 0, added in order from 0.
      acc_t tot = acc_t(0);
      for (int64_t k = k0; k < k1; ++k) {
        const int64_t s = item_segs[k];
        acc_t acc = acc_t(0);
        rows.sum(acc, seg_row_start[s], seg_row_start[s + 1], lane, zh,
                 z_ext, head, sentinel);
        tot += acc;
      }
      out[b * kLanes + lane] = static_cast<z_t>(tot);
      continue;
    }
    // One segment of a deep block: its partial, then the block's tickets.
    const int64_t s = item_segs[k0];
    acc_t acc = acc_t(0);
    rows.sum(acc, seg_row_start[s], seg_row_start[s + 1], lane, zh,
             z_ext, head, sentinel);
    partial[s * kLanes + lane] = acc;
    acc_t tot;
    if (ellp::finish_group<kChunk, kFinish>(
            partial, chunk_sum, counter + b, chunk_counter, s,
            block_seg_start[b], block_seg_start[b + 1], tickets + group,
            group, lane, tot))
      out[b * kLanes + lane] = static_cast<z_t>(tot);
  }
  for (; i < num_items + num_empty; i += stride)
    out[static_cast<int64_t>(empty_blocks[i - num_items]) * kLanes + lane] =
        z_t(0);
}

template <typename z_t, typename acc_t>
int launch(const void* z_ext, const void* src, const void* seg_row_start,
           const void* seg_block, const void* block_seg_start,
           const void* item_start, const void* item_segs,
           const void* empty_blocks, void* partial, void* chunk_sum,
           void* counter, void* chunk_counter, void* out, int64_t num_items,
           int64_t num_split, int64_t num_empty, int64_t sentinel,
           int64_t head, int64_t grid, void* stream) {
  const int64_t smem =
      (head * static_cast<int64_t>(sizeof(z_t)) + 15) / 16 * 16;
  static int64_t opted = 0;  // the bytes this instance may launch with
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_contrib_kernel<z_t, acc_t>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  ell_contrib_kernel<z_t, acc_t>
      <<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const z_t*>(z_ext), static_cast<const int32_t*>(src),
          static_cast<const int32_t*>(seg_row_start),
          static_cast<const int32_t*>(seg_block),
          static_cast<const int32_t*>(block_seg_start),
          static_cast<const int32_t*>(item_start),
          static_cast<const int32_t*>(item_segs),
          static_cast<const int32_t*>(empty_blocks),
          static_cast<acc_t*>(partial), static_cast<acc_t*>(chunk_sum),
          static_cast<int32_t*>(counter), static_cast<int32_t*>(chunk_counter),
          static_cast<z_t*>(out), num_items, num_split, num_empty,
          static_cast<uint32_t>(sentinel), static_cast<uint32_t>(head));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (z dtype, accumulation dtype) pair the port runs.
// Its arguments come packed in one int64 array, so a call from Python
// converts two values, not twenty: a[0..12] the pointers z_ext, src,
// seg_row_start, seg_block, block_seg_start, item_start, item_segs,
// empty_blocks, partial, chunk_sum, counter, chunk_counter, out; then
// num_items, num_split, num_empty, sentinel, head and grid.
#define ELL_CONTRIB_ENTRY(NAME, Z_T, ACC_T)                                  \
  extern "C" int NAME(const int64_t* a, void* stream) {                      \
    auto p = [a](int i) { return reinterpret_cast<void*>(a[i]); };          \
    return launch<Z_T, ACC_T>(p(0), p(1), p(2), p(3), p(4), p(5), p(6),     \
                              p(7), p(8), p(9), p(10), p(11), p(12), a[13], \
                              a[14], a[15], a[16], a[17], a[18], stream);   \
  }

ELL_CONTRIB_ENTRY(ell_contrib_f32_f32, float, float)
ELL_CONTRIB_ENTRY(ell_contrib_f32_f64, float, double)
ELL_CONTRIB_ENTRY(ell_contrib_f64_f64, double, double)

extern "C" const char* ell_contrib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
