// Device helpers of the persistent ELL kernels, K1 (ell_contrib.cu), K2
// (ell_contrib_partitioned.cu) and K1w (ell_contrib_spmm.cu). Each
// __global__ kernel and its constants stay in its .cu; what they share is
// here.
//
// The shape both kernels have: persistent CTAs of kThreads threads, cut
// into lane groups of 128 threads (one thread per lane of a slot row).
// A lane group walks its share of the host's work items (segments of the
// plan); it reads a segment's slot words with loads that do not allocate
// in L1, gathers up to kBatch rows' values at once, serving ids below the
// head H from the copy of z[0:H] the CTA staged in shared memory, and
// adds them in row order.
// A group split over several lane groups is finished by the lane group
// that draws its last ticket (see last_ticket).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ellp {

// The 128 threads of lane group `group` (named barrier group + 1;
// barrier 0 is __syncthreads, which would deadlock once the groups of a
// CTA take different paths).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;" ::"r"(group + 1) : "memory");
}

// Slot words are read once a launch: these loads bypass L1, so they do
// not evict the lines of z that are read again.
__device__ __forceinline__ uint32_t load_word32(const void* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// -- table elements ---------------------------------------------------------

// Widen a table element to its sum type. bf16 is carried as its raw 16
// bits; widening is exact (the bits become the high half of a float).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Copy table[0:head] into shared memory: 16-byte vectors (the wrapper
// holds the table 16-byte aligned), then the ragged tail.
template <typename T>
__device__ void stage_head(T* dst, const T* table, int64_t head, int tid,
                           int nthreads) {
  const int64_t vecs = head * static_cast<int64_t>(sizeof(T)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(table);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int64_t i = tid; i < vecs; i += nthreads) d[i] = __ldg(s + i);
  for (int64_t i = vecs * 16 / static_cast<int64_t>(sizeof(T)) + tid;
       i < head; i += nthreads)
    dst[i] = table[i];
}

// acc += the values of kBatch slot words, in order. A word below `head`
// reads the staged head, the sentinel reads no memory and adds +0.0 (a
// select: the add is still made), any other word reads through L1/L2.
// Every gather of the batch is issued before the first add.
template <int kBatch, typename T, typename acc_t>
__device__ __forceinline__ void gather_add(acc_t& acc, const uint32_t* w,
                                           const T* head_smem, const T* table,
                                           uint32_t head, uint32_t sentinel) {
  using val_t = decltype(widen(T()));
  val_t v[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    v[j] = val_t(0);
    if (w[j] != sentinel && w[j] >= head) v[j] = widen(__ldg(table + w[j]));
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (w[j] < head) v[j] = widen(head_smem[w[j]]);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) acc += static_cast<acc_t>(v[j]);
}

// -- the finisher -------------------------------------------------------------

// A release-acquire fence at GPU scope: lighter than __threadfence()'s
// sequentially consistent one, and all the ticket protocol needs.
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Called by all 128 threads of a lane group after each wrote its part of
// a group's partial: draw a ticket on the group's counter and return (in
// every thread) whether this was the last of `count` tickets. One thread
// fences and draws for the group after the group's barrier (the grid
// barrier's pattern: the fence is cumulative over the writes the barrier
// ordered before it), and fences again when it drew the last ticket. The
// last group then reads the partials with loads that go to L2 (__ldcg),
// never through the non-coherent read-only path.
__device__ __forceinline__ bool last_ticket(int32_t* counter, int count,
                                            int* slot, int group, int lane) {
  group_sync(group);
  if (lane == 0) {
    fence_acq_rel();
    const int t = atomicAdd(counter, 1);
    if (t == count - 1) fence_acq_rel();
    *slot = t;
  }
  group_sync(group);
  return *slot == count - 1;
}

// 0 + p[first] + p[first + stride] + ... (count rows; one lane's column
// of 128-wide rows), in row order, kFinish loads in flight.
template <int kFinish, typename acc_t>
__device__ acc_t sum_rows(const acc_t* p, int64_t first, int64_t count,
                          int64_t stride, int lane) {
  acc_t tot = acc_t(0);
  const acc_t* q = p + first * 128 + lane;
  int64_t j = 0;
  for (; j + kFinish <= count; j += kFinish) {
    acc_t v[kFinish];
#pragma unroll
    for (int k = 0; k < kFinish; ++k) v[k] = __ldcg(q + (j + k) * stride * 128);
#pragma unroll
    for (int k = 0; k < kFinish; ++k) tot += v[k];
  }
  for (; j < count; ++j) tot += __ldcg(q + j * stride * 128);
  return tot;
}

// The same over the rows idx[q0], idx[q0+1], ..., idx[q1-1].
template <int kFinish, typename acc_t>
__device__ acc_t sum_rows_at(const acc_t* p, const int32_t* idx, int64_t q0,
                             int64_t q1, int lane) {
  acc_t tot = acc_t(0);
  int64_t q = q0;
  for (; q + kFinish <= q1; q += kFinish) {
    acc_t v[kFinish];
#pragma unroll
    for (int j = 0; j < kFinish; ++j)
      v[j] = __ldcg(p + static_cast<int64_t>(idx[q + j]) * 128 + lane);
#pragma unroll
    for (int j = 0; j < kFinish; ++j) tot += v[j];
  }
  for (; q < q1; ++q)
    tot += __ldcg(p + static_cast<int64_t>(idx[q]) * 128 + lane);
  return tot;
}

// Segment s of a group whose segments are [s0, s1) (2 or more) has
// written partial[s]; returns true in the lane group that completes the
// group, its sum in `tot`. A group of at most kChunk segments is summed
// in segment order from 0. A deeper one is cut into chunks of kChunk
// consecutive segments: the lane group that completes a chunk sums its
// partials from 0 into chunk_sum[first segment of the chunk], and the
// one that completes the last chunk sums the chunk sums in order from 0,
// so no lane group sums more than kChunk + (s1 - s0) / kChunk rows. Every
// counter it completes is left 0.
template <int kChunk, int kFinish, typename acc_t>
__device__ bool finish_group(const acc_t* partial, acc_t* chunk_sum,
                             int32_t* counter, int32_t* chunk_counter,
                             int64_t s, int64_t s0, int64_t s1, int* slot,
                             int group, int lane, acc_t& tot) {
  const int64_t n = s1 - s0;
  if (n <= kChunk) {
    if (!last_ticket(counter, static_cast<int>(n), slot, group, lane))
      return false;
    tot = sum_rows<kFinish>(partial, s0, n, 1, lane);
    if (lane == 0) atomicExch(counter, 0);
    return true;
  }
  const int64_t c0 = s0 + (s - s0) / kChunk * kChunk;
  const int64_t c1 = c0 + kChunk < s1 ? c0 + kChunk : s1;
  if (!last_ticket(chunk_counter + c0, static_cast<int>(c1 - c0), slot, group,
                   lane))
    return false;
  chunk_sum[c0 * 128 + lane] = sum_rows<kFinish>(partial, c0, c1 - c0, 1, lane);
  if (lane == 0) atomicExch(chunk_counter + c0, 0);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  if (!last_ticket(counter, static_cast<int>(chunks), slot, group, lane))
    return false;
  tot = sum_rows<kFinish>(chunk_sum, s0, chunks, kChunk, lane);
  if (lane == 0) atomicExch(counter, 0);
  return true;
}

// -- the finisher at any row width (K1w, ell_contrib_spmm.cu) -------------------
// The same protocol for a lane group of `nthreads` threads (128 x the
// threads a lane) whose partial rows are `row` elements wide: thread
// `tid` of the group owns the kN elements at offsets off[] of each row.

// The `nthreads` threads of lane group `group` (named barrier group + 1).
__device__ __forceinline__ void group_sync_n(int group, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(nthreads) : "memory");
}

// last_ticket for a group of `nthreads` threads; `tid` 0 draws.
__device__ __forceinline__ bool last_ticket_n(int32_t* counter, int count,
                                              int* slot, int group, int tid,
                                              int nthreads) {
  group_sync_n(group, nthreads);
  if (tid == 0) {
    fence_acq_rel();
    const int t = atomicAdd(counter, 1);
    if (t == count - 1) fence_acq_rel();
    *slot = t;
  }
  group_sync_n(group, nthreads);
  return *slot == count - 1;
}

// tot[e] = 0 + p[first * row + off[e]] + p[(first + stride) * row + off[e]]
// + ... (count rows), in row order, kFinish rows in flight.
template <int kFinish, int kN, typename acc_t>
__device__ void sum_rows_n(acc_t (&tot)[kN], const acc_t* p, int64_t first,
                           int64_t count, int64_t stride, int64_t row,
                           const int (&off)[kN]) {
#pragma unroll
  for (int e = 0; e < kN; ++e) tot[e] = acc_t(0);
  const acc_t* q = p + first * row;
  int64_t j = 0;
  for (; j + kFinish <= count; j += kFinish) {
    acc_t v[kFinish][kN];
#pragma unroll
    for (int k = 0; k < kFinish; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e)
        v[k][e] = __ldcg(q + (j + k) * stride * row + off[e]);
#pragma unroll
    for (int k = 0; k < kFinish; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e) tot[e] += v[k][e];
  }
  for (; j < count; ++j)
#pragma unroll
    for (int e = 0; e < kN; ++e) tot[e] += __ldcg(q + j * stride * row + off[e]);
}

// finish_group over rows of `row` elements: the same tickets, chunks and
// sum order, each element of the thread's kN on its own.
template <int kChunk, int kFinish, int kN, typename acc_t>
__device__ bool finish_group_n(const acc_t* partial, acc_t* chunk_sum,
                               int32_t* counter, int32_t* chunk_counter,
                               int64_t s, int64_t s0, int64_t s1, int* slot,
                               int group, int tid, int nthreads, int64_t row,
                               const int (&off)[kN], acc_t (&tot)[kN]) {
  const int64_t n = s1 - s0;
  if (n <= kChunk) {
    if (!last_ticket_n(counter, static_cast<int>(n), slot, group, tid,
                       nthreads))
      return false;
    sum_rows_n<kFinish>(tot, partial, s0, n, 1, row, off);
    if (tid == 0) atomicExch(counter, 0);
    return true;
  }
  const int64_t c0 = s0 + (s - s0) / kChunk * kChunk;
  const int64_t c1 = c0 + kChunk < s1 ? c0 + kChunk : s1;
  if (!last_ticket_n(chunk_counter + c0, static_cast<int>(c1 - c0), slot,
                     group, tid, nthreads))
    return false;
  acc_t cs[kN];
  sum_rows_n<kFinish>(cs, partial, c0, c1 - c0, 1, row, off);
#pragma unroll
  for (int e = 0; e < kN; ++e) chunk_sum[c0 * row + off[e]] = cs[e];
  if (tid == 0) atomicExch(chunk_counter + c0, 0);
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  if (!last_ticket_n(counter, static_cast<int>(chunks), slot, group, tid,
                     nthreads))
    return false;
  sum_rows_n<kFinish>(tot, chunk_sum, s0, chunks, kChunk, row, off);
  if (tid == 0) atomicExch(counter, 0);
  return true;
}

// -- the slot stream of one lane group ----------------------------------------

// The slot words of a segment's rows, kBatch rows at a time: each thread
// loads its lane's words straight from global memory (L1::no_allocate),
// a segment's next batch while it gathers one. A batch starts at a
// segment's first row or kBatch rows after the last one; rows past the
// segment's end read as the sentinel.
template <bool kWords24, int kBatch>
struct SlotStream {
  static constexpr int kRowBytes = (kWords24 ? 3 : 4) * 128;

  const unsigned char* src;  // slot rows, kRowBytes each

  // What a thread loads of row `row` for its lane: its int32 word, or,
  // for 3-byte words, one 32-bit piece of its warp's 96 bytes of the row
  // (threads 0-23 of the warp: plane t / 8, bytes 4 (t % 8) of the
  // warp's 32 in that plane), which decode() deals out by warp shuffles.
  __device__ __forceinline__ uint32_t word_at(const unsigned char* row,
                                              int lane) const {
    if constexpr (kWords24) {
      const int t = lane & 31;
      return t < 24 ? load_word32(row + (t >> 3) * 128 + 32 * (lane >> 5) +
                                  4 * (t & 7))
                    : 0u;
    } else {
      return load_word32(row + 4 * lane);
    }
  }

  // What each thread loads for rows [r, r + kBatch) of a segment ending
  // at r1 (rows past r1 load nothing); decode() makes them words.
  __device__ __forceinline__ void next(int64_t r, int64_t r1, int lane,
                                       uint32_t* w) const {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      w[j] = r + j < r1 ? word_at(src + (r + j) * kRowBytes, lane) : 0u;
  }

  // The slot words of rows [r, r + kBatch) from what next() loaded; rows
  // past r1 read as the sentinel. Every thread of the warp takes part.
  __device__ __forceinline__ void decode(const uint32_t* raw, int64_t r,
                                         int64_t r1, int lane,
                                         uint32_t sentinel,
                                         uint32_t* w) const {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      uint32_t v = raw[j];
      if constexpr (kWords24) {
        const int t = (lane & 31) >> 2, shift = 8 * (lane & 3);
        v = ((__shfl_sync(0xffffffffu, raw[j], t) >> shift) & 0xffu) |
            (((__shfl_sync(0xffffffffu, raw[j], 8 + t) >> shift) & 0xffu)
             << 8) |
            (((__shfl_sync(0xffffffffu, raw[j], 16 + t) >> shift) & 0xffu)
             << 16);
      }
      w[j] = r + j < r1 ? v : sentinel;
    }
  }

  // acc += the values of rows [r0, r1) in row order, from the staged head
  // below `head`, the table elsewhere, the sentinel as +0.0; the next
  // batch's words are in flight while a batch gathers.
  template <typename T, typename acc_t>
  __device__ __forceinline__ void sum(acc_t& acc, int64_t r0, int64_t r1,
                                      int lane, const T* head_smem,
                                      const T* table, uint32_t head,
                                      uint32_t sentinel) const {
    uint32_t raw[kBatch];
    next(r0, r1, lane, raw);
    for (int64_t r = r0; r < r1; r += kBatch) {
      uint32_t w[kBatch];
      decode(raw, r, r1, lane, sentinel, w);
      if (r + kBatch < r1) next(r + kBatch, r1, lane, raw);
      gather_add<kBatch>(acc, w, head_smem, table, head, sentinel);
    }
  }
};

}  // namespace ellp
