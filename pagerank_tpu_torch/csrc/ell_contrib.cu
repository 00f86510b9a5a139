// K1 on Hopper: the blocked-ELL contribution SpMV, contrib = A^T_norm * r.
//
// Replaces pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas (kernel body
// _kernel). For each dst block b and lane l:
//
//     out[b*128 + l] = sum over rows r of block b of z_ext[src[r, l]]
//
// summed in acc_t (float or double) and written in z_t. z_ext is the rank
// vector prescaled by 1/out-degree with 8 trailing zeros; inert slots hold
// the sentinel index n_state, which reads one of those zeros.
//
// Bound: device-memory bytes. Each step must stream the whole slot table
// (rows*128*4 bytes) once, plus z (n_pad*sizeof(z_t)), the output
// (n_pad*sizeof(z_t)) and the plan; at 3.35 TB/s that is the least time the
// card can take. The gathers of z are random, so they are served by the
// 50 MB L2 (z is 16.8 MB in f32 at R-MAT scale 22) rather than by HBM.
//
// What the design does about it. On the TPU the grid ran in order and each
// 256-row chunk read-modify-wrote its partial into the chunk's first dst
// block. Hopper runs blocks in parallel and in no order, and the in-degree
// relabel makes block 0 the deepest (about 1e5 rows on a scale-22 hub), so
// one CTA per dst block would leave the sweep waiting on block 0. Instead
// this is a two-pass segmented reduction with no atomics:
//
//   pass 1: one CTA of 128 threads per segment of at most SEG_ROWS rows
//           (the host's segment_plan, pagerank_tpu_torch/ops/ell.py); one
//           thread per lane walks the segment's rows: a coalesced 512-byte
//           read of src per row, a gathered read of z through L2, a register
//           sum in acc_t. It writes partial[seg, lane] in acc_t.
//   pass 2: one thread per (block, lane) sums the block's partials in
//           segment order and writes out (0 for an empty block).
//
// The order of every sum is fixed by the plan, so the result is
// bit-identical from run to run on one card (the resume test needs that).
// The kernel allocates nothing: the caller passes partial [S, 128] and out
// [num_blocks*128]. Each entry point launches on the caller's stream, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

template <typename z_t, typename acc_t>
__global__ void __launch_bounds__(kLanes)
segment_partials(const z_t* __restrict__ z_ext,
                 const int32_t* __restrict__ src,
                 const int32_t* __restrict__ seg_row_start,
                 acc_t* __restrict__ partial) {
  const int64_t seg = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t r0 = seg_row_start[seg];
  const int64_t r1 = seg_row_start[seg + 1];
  const int32_t* row = src + r0 * kLanes + lane;
  acc_t acc = acc_t(0);
#pragma unroll 4
  for (int64_t r = r0; r < r1; ++r, row += kLanes) {
    acc += static_cast<acc_t>(__ldg(z_ext + __ldg(row)));
  }
  partial[seg * kLanes + lane] = acc;
}

template <typename z_t, typename acc_t>
__global__ void block_sums(const acc_t* __restrict__ partial,
                           const int32_t* __restrict__ block_seg_start,
                           z_t* __restrict__ out, int64_t num_blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_blocks * kLanes) return;
  const int64_t b = i / kLanes;
  const int64_t lane = i % kLanes;
  const int64_t s0 = block_seg_start[b];
  const int64_t s1 = block_seg_start[b + 1];
  acc_t acc = acc_t(0);
  for (int64_t s = s0; s < s1; ++s) {
    acc += partial[s * kLanes + lane];
  }
  out[i] = static_cast<z_t>(acc);
}

template <typename z_t, typename acc_t>
int launch(const void* z_ext, const void* src, const void* seg_row_start,
           const void* block_seg_start, void* partial, void* out,
           int64_t num_segs, int64_t num_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_segs > 0) {
    segment_partials<z_t, acc_t><<<static_cast<unsigned>(num_segs), kLanes, 0, s>>>(
        static_cast<const z_t*>(z_ext), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(seg_row_start),
        static_cast<acc_t*>(partial));
  }
  const int64_t total = num_blocks * kLanes;
  if (total > 0) {
    const int threads = 256;
    const int64_t grid = (total + threads - 1) / threads;
    block_sums<z_t, acc_t><<<static_cast<unsigned>(grid), threads, 0, s>>>(
        static_cast<const acc_t*>(partial),
        static_cast<const int32_t*>(block_seg_start), static_cast<z_t*>(out),
        num_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (z dtype, accumulation dtype) pair the port runs.
#define ELL_CONTRIB_ENTRY(NAME, Z_T, ACC_T)                                   \
  extern "C" int NAME(const void* z_ext, const void* src,                     \
                      const void* seg_row_start, const void* block_seg_start, \
                      void* partial, void* out, int64_t num_segs,             \
                      int64_t num_blocks, void* stream) {                     \
    return launch<Z_T, ACC_T>(z_ext, src, seg_row_start, block_seg_start,     \
                              partial, out, num_segs, num_blocks, stream);    \
  }

ELL_CONTRIB_ENTRY(ell_contrib_f32_f32, float, float)
ELL_CONTRIB_ENTRY(ell_contrib_f32_f64, float, double)
ELL_CONTRIB_ENTRY(ell_contrib_f64_f64, double, double)

extern "C" const char* ell_contrib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
