// K2 on Hopper: the pair sums of the partition-centric layout.
//
// Replaces pagerank_tpu/ops/pallas_spmv.py:ell_contrib_pallas_partitioned
// (kernel body _kernel_partitioned). The source range is split into K
// partitions; the slot rows are concatenated partition-major and every
// row belongs to one (dst block, source partition) pair, numbered densely
// in row order. For each pair p and lane l:
//
//     out[p*128 + l] = sum over rows r of pair p of
//                      window(part(p))[word(r, l)]
//
// summed in float. window(k) = z + k*window_stride is partition k's slice
// of the prescaled rank vector (psz lanes, then zeros), stored as float or
// as bf16 (the bf16 stream, widened to float here). word(r, l) is the
// partition-LOCAL source id of slot (r, l): 3 bytes in planar form (byte
// plane b of row r at src8[r*384 + b*128 + l]) or an int32. Inert slots
// hold the local sentinel psz, which reads a zero of the window's tail.
//
// Bound: device-memory bytes. A step must stream the slot words once
// (rows*384 bytes, or rows*512 as int32), read the windows (K*window
// elements) and the plan, and write the pair output (pairs*128*4 bytes).
// The gathers are random, but one window is at most a few MB and the
// whole table fits the 50 MB L2 at R-MAT scale 22.
//
// What the design does about it. The TPU kernel walked an ordered grid
// of 1024-row chunks, DMAed its partition's window into VMEM, unpacked the
// words on the core, summed the chunk by a one-hot matmul and
// read-modify-wrote the partial into its pair output. Hopper runs blocks
// in no order, so this is K1's two-pass segmented reduction with no
// atomics (csrc/ell_contrib.cu), over pairs instead of dst blocks:
//
//   pass 1: one CTA of 128 threads per segment of at most SEG_ROWS rows of
//           one pair (the host's segment_plan over the global pair ranks);
//           the CTA reads its pair's partition from the plan. One thread
//           per lane walks the rows: three coalesced 128-byte reads of the
//           byte planes (or one 512-byte int32 row), the word assembled in
//           a register, the window gathered through L2, a float sum in a
//           register. A pair that has one segment is written straight to
//           out; a longer pair's segment writes partial[seg, lane].
//   pass 2: one thread per (pair, lane) of a pair with more than one
//           segment sums its partials in segment order; a pair with no
//           segment (an empty partition's sentinel pair) writes 0.
//
// Every sum has an order fixed by the plan, so results are bit-identical
// from run to run (the resume test needs that). Staging a window in
// shared memory (spans up to ~56k f32 or ~113k bf16 vertices fit the
// 227 KB of a block), cp.async/TMA for the slot rows, and fusing pass 2
// with the pair -> block expansion are later work. The kernel allocates
// nothing: the caller passes partial [segs, 128] and out [pairs*128].
// Each entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;

// Table element -> float. bf16 is carried as its raw 16 bits; widening
// is exact: the bits become the high half of a float (what
// __bfloat162float does).
__device__ __forceinline__ float widen(const float* z, int64_t i) {
  return __ldg(z + i);
}
__device__ __forceinline__ float widen(const uint16_t* z, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(z + i)) << 16);
}

// Slot word of row r, lane l. Read as unsigned bytes, so the int8 planes
// of the host layout need no sign mask here.
template <bool kWords24>
__device__ __forceinline__ uint32_t slot_word(const void* src, int64_t r,
                                              int lane) {
  if constexpr (kWords24) {
    const uint8_t* row =
        static_cast<const uint8_t*>(src) + r * (3 * kLanes) + lane;
    return static_cast<uint32_t>(__ldg(row)) |
           (static_cast<uint32_t>(__ldg(row + kLanes)) << 8) |
           (static_cast<uint32_t>(__ldg(row + 2 * kLanes)) << 16);
  } else {
    return static_cast<uint32_t>(
        __ldg(static_cast<const int32_t*>(src) + r * kLanes + lane));
  }
}

template <typename table_t, bool kWords24>
__global__ void __launch_bounds__(kLanes)
pair_segment_partials(const table_t* __restrict__ z, int64_t window_stride,
                      const void* __restrict__ src,
                      const int32_t* __restrict__ seg_row_start,
                      const int32_t* __restrict__ seg_pair,
                      const int32_t* __restrict__ pair_seg_start,
                      const int32_t* __restrict__ pair_part,
                      float* __restrict__ partial, float* __restrict__ out) {
  const int64_t seg = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t r0 = seg_row_start[seg];
  const int64_t r1 = seg_row_start[seg + 1];
  const int64_t pair = seg_pair[seg];
  const table_t* win = z + static_cast<int64_t>(pair_part[pair]) * window_stride;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t r = r0; r < r1; ++r) {
    acc += widen(win, slot_word<kWords24>(src, r, lane));
  }
  if (pair_seg_start[pair + 1] - pair_seg_start[pair] == 1) {
    out[pair * kLanes + lane] = acc;
  } else {
    partial[seg * kLanes + lane] = acc;
  }
}

__global__ void pair_sums(const float* __restrict__ partial,
                          const int32_t* __restrict__ pair_seg_start,
                          float* __restrict__ out, int64_t num_pairs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_pairs * kLanes) return;
  const int64_t p = i / kLanes;
  const int64_t lane = i % kLanes;
  const int64_t s0 = pair_seg_start[p];
  const int64_t s1 = pair_seg_start[p + 1];
  if (s1 - s0 == 1) return;  // written by pass 1
  float acc = 0.0f;
  for (int64_t s = s0; s < s1; ++s) {
    acc += partial[s * kLanes + lane];
  }
  out[i] = acc;
}

template <typename table_t, bool kWords24>
int launch(const void* z, const void* src, const void* seg_row_start,
           const void* seg_pair, const void* pair_seg_start,
           const void* pair_part, void* partial, void* out,
           int64_t window_stride, int64_t num_segs, int64_t num_pairs,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pss = static_cast<const int32_t*>(pair_seg_start);
  if (num_segs > 0) {
    pair_segment_partials<table_t, kWords24>
        <<<static_cast<unsigned>(num_segs), kLanes, 0, s>>>(
            static_cast<const table_t*>(z), window_stride, src,
            static_cast<const int32_t*>(seg_row_start),
            static_cast<const int32_t*>(seg_pair), pss,
            static_cast<const int32_t*>(pair_part),
            static_cast<float*>(partial), static_cast<float*>(out));
  }
  const int64_t total = num_pairs * kLanes;
  if (total > 0) {
    const int threads = 256;
    const int64_t grid = (total + threads - 1) / threads;
    pair_sums<<<static_cast<unsigned>(grid), threads, 0, s>>>(
        static_cast<const float*>(partial), pss, static_cast<float*>(out),
        num_pairs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per (table type, slot-word form); float sums always.
#define PART_ENTRY(NAME, TABLE_T, WORDS24)                                     \
  extern "C" int NAME(const void* z, const void* src,                          \
                      const void* seg_row_start, const void* seg_pair,         \
                      const void* pair_seg_start, const void* pair_part,       \
                      void* partial, void* out, int64_t window_stride,         \
                      int64_t num_segs, int64_t num_pairs, void* stream) {     \
    return launch<TABLE_T, WORDS24>(z, src, seg_row_start, seg_pair,           \
                                    pair_seg_start, pair_part, partial, out,   \
                                    window_stride, num_segs, num_pairs,        \
                                    stream);                                   \
  }

PART_ENTRY(ell_contrib_part_f32_w24, float, true)
PART_ENTRY(ell_contrib_part_f32_w32, float, false)
PART_ENTRY(ell_contrib_part_bf16_w24, uint16_t, true)
PART_ENTRY(ell_contrib_part_bf16_w32, uint16_t, false)

extern "C" const char* ell_contrib_part_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
