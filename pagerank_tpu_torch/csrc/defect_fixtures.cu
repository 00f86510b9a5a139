// F1-F6 on Hopper: the seeded-defect fixtures of the kernel-plane check.
//
// Replace the fixtures of pagerank_tpu/analysis/kernels.py:defect_cases
// (the pl.pallas_call sites at :358, :371, :384, :398, :411, :425; bodies
// _fx_copy :330, _fx_scratch :334, _fx_matmul :339). Each fixture is a
// small kernel whose launch geometry trips exactly one rule of
// pagerank_tpu_torch/analysis/kernels.py, and whose function is the JAX
// fixture's, so the card can show the fault the rule names:
//
//   F1 vmem_overflow   fx_copy_bulk, x f32 [n] staged whole in dynamic
//                      shared memory by one CTA: at the fixture's n =
//                      8,388,608 that is 33,554,432 bytes, past the
//                      232,448 a block may use (PTK001), so the launch is
//                      refused.
//   F2 misaligned_tile fx_copy_rows over (100, 64) tiles of x, out f32
//                      [200, 128], one thread per tile row, each row one
//                      256-byte bulk copy in and one out: 100-thread
//                      blocks, not a whole number of warps (PTK002).
//   F3 index_gap       fx_copy_rows over (8, 128) tiles, x [16, 128] -> out
//                      [32, 128], out tile 2i <- x tile i, each tile one
//                      4 KiB bulk copy in and one out: out tiles 1 and 3
//                      are never written (PTK003); the entry fills them
//                      with NaN before the launch.
//   F4 index_overlap   fx_copy_rows over (8, 128) tiles, x [32, 128] ->
//                      out [16, 128], out tile i % 2 <- x tile i, each
//                      tile one 4 KiB bulk copy in and one out: two CTAs
//                      write each out tile, in no order (PTK003); past
//                      the fixture's 32 rows the entry fills the out
//                      tiles from 2 on, which no CTA writes, with NaN.
//   F5 f64_scratch     fx_scratch: acc = -acc on a __shared__ double
//                      (8, 128) scratch, out = x moved as float4, in an
//                      f32 case (PTK004).
//   F6 cost_mismatch   fx_matmul_3xtf32: out = x y in f32, x [256, 128], y
//                      [128, 128], on the tensor cores, a correct kernel
//                      registered with the analytic model {flops 1,
//                      bytes 1} (PTK005).
//
// Bound: device-memory bytes for the copies (each input read once, each
// output written once); F6 does 8.4 MFLOP on 320 KiB, also below the
// card's ridge point. At the fixtures' KiB shapes a call is its launch,
// so the design keeps the launch and the device work short: F1 stages
// the array through shared memory as the TPU staged its block through
// VMEM, but with Hopper's bulk asynchronous copies (one thread issues a
// global -> shared copy that completes on an mbarrier, then a shared ->
// global bulk group); F2, F3 and F4 move each tile the same way, so a
// CTA's loads are all in flight at once and no thread computes an
// element's index: F2 a copy a 256-byte tile row, each by its own thread;
// F3's and F4's (8, 128) tile is one contiguous 4 KiB span in x and in
// out, so one thread moves it with one copy each way, not eight. F5
// moves its (8, 128) tile as 16-byte vectors. F6 spreads its output over
// 64 x 64 tiles (8 CTAs at the fixture's shape, where one 128 x 128
// tile a CTA used 2 of the 132 SMs), stages x's and y's 32-deep slices
// in a ring of shared-memory stages by 16-byte cp.async copies, eight a
// thread (a bulk copy a row would be 96 small requests a slice, queued
// on the SM's one copy engine), and multiplies on the tensor cores with
// mma.sync m16n8k8 in TF32 three times (3xTF32: each operand split into
// a TF32 high part and a TF32 low part; lo*hi + hi*lo + hi*hi) for f32
// accuracy. Each 32-deep slice is summed into a fresh accumulator and
// folded into the f32 total, so the tensor cores' truncating sums never
// grow past a slice. mma.sync and not wgmma: TF32 wgmma takes B only
// K-major, and y is [k, n] row-major.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the CUDA error of its launch (F3 and F4
// first that of their NaN fill, a cudaMemset2DAsync or a cudaMemsetAsync
// on the same stream; F4 makes no fill call where it has no gap). F1
// and F6 first opt their kernel in to its dynamic shared memory with
// cudaFuncSetAttribute, asked only when the request is more than the
// current device last granted; when that is refused (F1 at its geometry)
// they clear the error with cudaGetLastError, so it does not reach the
// next launch's check, and return it without launching. F2, F3 and F4
// stage at most 25,600 bytes, under the 48 KB a block gets without
// asking. F1-F5 need x and out 16-byte aligned, F6 x and y (their
// wrappers check).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <mutex>

namespace {

constexpr int kLanes = 128;
constexpr int kTileRows = 8;         // F3-F5: (8, 128) f32 tiles
constexpr int kWholeThreads = 1024;  // F1: one CTA stages the whole array
constexpr int kMisTileRows = 100;    // F2: (100, 64) tiles, one thread a row
constexpr int kMisTileCols = 64;
constexpr int kMatTileM = 64;        // F6: 64 x 64 output tile per CTA
constexpr int kMatTileN = 64;
constexpr int kMatThreads = 128;     // F6: 4 warps, a quadrant of it each
constexpr int kMatWarpM = kMatTileM / 2;  // F6: a warp's quadrant
constexpr int kMatWarpN = kMatTileN / 2;
constexpr int kMatK = 32;            // F6: depth of one ring stage
constexpr int kMatStages = 4;        // F6: stages in the ring
// F6: floats a staged x row and y row; the pads make the mma fragments'
// shared-memory reads conflict-free (lanes 4g + t and 8t + g on 32
// banks) and keep each row 16-byte aligned for its cp.async copies.
constexpr int kMatXPitch = kMatK + 4;
constexpr int kMatYPitch = kMatTileN + 8;
constexpr int kMatStageFloats = kMatTileM * kMatXPitch + kMatK * kMatYPitch;
constexpr int kVec = 4;              // F1, F5, F6: floats in a 16-byte vector
constexpr int kMaxDevices = 64;

// F1: x -> shared memory -> out, the whole array in one CTA. Thread 0
// moves the head (the first n - n % 4 elements, a whole number of 16-byte
// vectors) with two bulk copies: global -> shared completing on the
// mbarrier `staged`, armed with the head's bytes; then shared -> global as
// a bulk group, whose reads of shared memory it waits for before the CTA
// exits. The tail (n % 4 elements) goes through shared memory by the
// first threads. x and out are 16-byte aligned.
__global__ void __launch_bounds__(kWholeThreads)
fx_copy_bulk(const float* __restrict__ x, float* __restrict__ out,
             int64_t n) {
  extern __shared__ __align__(16) float whole[];
  __shared__ uint64_t staged;
  const int64_t head = n - n % kVec;
  const int64_t t = head + threadIdx.x;
  if (t < n) {
    whole[t] = x[t];
    out[t] = whole[t];
  }
  if (threadIdx.x != 0 || head == 0) return;
  const uint32_t bytes = static_cast<uint32_t>(head * sizeof(float));
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&staged));
  const uint32_t smem =
      static_cast<uint32_t>(__cvta_generic_to_shared(whole));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem), "l"(x), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile(
      "{\n"
      ".reg .pred staged_p;\n"
      "FX_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 staged_p, [%0], %1;\n"
      "@!staged_p bra FX_WAIT;\n"
      "}\n" ::"r"(bar), "r"(0)
      : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(out), "r"(smem), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// F2, F3, F4: tile (i, j) of x -> dynamic shared memory -> tile
// ((out_mul*i) % out_mod, j) of out, tiles tile_rows x tile_cols of
// row-major arrays whose rows are x_cols and out_cols wide, by bulk copies
// of span_rows tile rows each (span_rows divides tile_rows; a span of more
// than one row is contiguous only where tile_cols == x_cols == out_cols).
// Thread 0 arms the mbarrier `staged` with the tile's bytes; after the
// block's barrier thread s copies span s global -> shared, completing on
// `staged`; each thread with a span waits for the whole tile, then stores
// its span shared -> global as a bulk group and waits for its reads of
// shared memory before it exits. x and out are 16-byte aligned, and a
// span's bytes and offsets are multiples of 16.
__global__ void __launch_bounds__(kLanes)
fx_copy_rows(const float* __restrict__ x, float* __restrict__ out,
             int64_t x_cols, int64_t out_cols, int tile_rows, int tile_cols,
             int span_rows, unsigned out_mul, unsigned out_mod) {
  extern __shared__ __align__(16) float tile[];
  __shared__ uint64_t staged;
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(&staged));
  if (threadIdx.x == 0) {
    const uint32_t tile_bytes =
        static_cast<uint32_t>(tile_rows * tile_cols * sizeof(float));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(tile_bytes)
                 : "memory");
  }
  __syncthreads();
  const int r = static_cast<int>(threadIdx.x) * span_rows;
  if (r >= tile_rows) return;
  const uint32_t bytes =
      static_cast<uint32_t>(span_rows * tile_cols * sizeof(float));
  const int64_t col = static_cast<int64_t>(blockIdx.y) * tile_cols;
  const float* src =
      x + (static_cast<int64_t>(blockIdx.x) * tile_rows + r) * x_cols + col;
  float* dst = out + (static_cast<int64_t>((out_mul * blockIdx.x) % out_mod)
                      * tile_rows + r) * out_cols + col;
  const uint32_t smem =
      static_cast<uint32_t>(__cvta_generic_to_shared(tile + r * tile_cols));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile(
      "{\n"
      ".reg .pred staged_p;\n"
      "FX_ROWS_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 staged_p, [%0], %1;\n"
      "@!staged_p bra FX_ROWS_WAIT;\n"
      "}\n" ::"r"(bar), "r"(0)
      : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// F5: one (8, 128) tile per CTA, 128 threads. The scratch is volatile so
// the compiler keeps it, as the TPU kept its VMEM scratch; each thread
// negates its lane of it, then moves two float4 of the tile (vectors
// lane and lane + 128 of its 256). x and out are 16-byte aligned.
__global__ void __launch_bounds__(kLanes)
fx_scratch(const float* __restrict__ x, float* __restrict__ out) {
  volatile __shared__ double acc[kTileRows][kLanes];
  const int lane = threadIdx.x;
  for (int r = 0; r < kTileRows; ++r) acc[r][lane] = -acc[r][lane];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileRows * kLanes;
  const float4* xs = reinterpret_cast<const float4*>(x + base);
  float4* os = reinterpret_cast<float4*>(out + base);
  const float4 a = xs[lane];
  const float4 b = xs[lane + kLanes];
  os[lane] = a;
  os[lane + kLanes] = b;
}

// A TF32 value (the low 13 bits of an f32 cleared), v rounded to
// nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 |v|: hi is v in TF32, lo the rest in TF32
// (v - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a b on one 16 x 8 x 8 tile: a's fragment (rows g, g + 8; columns
// t, t + 4), b's (rows t, t + 4; column g), d's (rows g, g + 8; columns
// 2t, 2t + 1), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Slice `chunk` of F6's operands into the ring stage at `stage` by
// 16-byte cp.async copies (eight a thread at a 64 x 64 tile): x's rows
// [row0, row0 + kMatTileM) at depth [32 chunk, 32 chunk + 32) (eight
// copies a row), then y's rows at that depth, columns [col0, col0 +
// kMatTileN); neighbouring threads copy neighbouring 16 bytes.
__device__ __forceinline__ void stage_slice(const float* x, const float* y,
                                            float* stage, int64_t row0,
                                            int64_t col0, int64_t k_dim,
                                            int64_t chunk) {
  constexpr int kXVecs = kMatK / kVec;     // 16-byte copies an x row
  constexpr int kYVecs = kMatTileN / kVec;  // and a y row
  const int64_t k0 = chunk * kMatK;
#pragma unroll
  for (int u = 0; u < (kMatTileM * kXVecs + kMatK * kYVecs) / kMatThreads;
       ++u) {
    const int q = u * kMatThreads + static_cast<int>(threadIdx.x);
    const float* src;
    float* dst;
    if (q < kMatTileM * kXVecs) {
      const int r = q / kXVecs, v = q % kXVecs;
      src = x + (row0 + r) * k_dim + k0 + kVec * v;
      dst = stage + r * kMatXPitch + kVec * v;
    } else {
      const int k = (q - kMatTileM * kXVecs) / kYVecs;
      const int v = (q - kMatTileM * kXVecs) % kYVecs;
      src = y + (k0 + k) * kLanes + col0 + kVec * v;
      dst = stage + kMatTileM * kMatXPitch + k * kMatYPitch + kVec * v;
    }
    const uint32_t smem =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
                 "l"(src)
                 : "memory");
  }
}

// F6: out = x y, x [m, k_dim], y [k_dim, 128], m % kMatTileM == 0,
// k_dim % 32 == 0, x and y 16-byte aligned. CTA (i, j) computes out's
// kMatTileM x kMatTileN tile (i, j); warp w its quadrant (w / 2, w % 2)
// as kMT x kNT mma tiles of 16 x 8.
// The k_dim / 32 slices pass through a ring of kMatStages stages (all
// four in flight at once at k_dim = 128), one cp.async group a slice: a
// thread waits for its own copies of slice c (all but the newest
// kMatStages - 1 groups), the block's barrier makes every thread's
// visible, and once every thread has read the stage it is refilled.
// Each slice's products go into a fresh accumulator in the order lo*hi,
// hi*lo, hi*hi, which is then added to the total; the order is fixed,
// so repeat calls are bit-identical.
__global__ void __launch_bounds__(kMatThreads)
fx_matmul_3xtf32(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int64_t k_dim) {
  extern __shared__ __align__(16) float ring[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int kMT = kMatWarpM / 16, kNT = kMatWarpN / 8;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMatTileM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kMatTileN;
  const int64_t chunks = k_dim / kMatK;
  for (int64_t c = 0; c < kMatStages; ++c) {
    if (c < chunks) {
      stage_slice(x, y, ring + c * kMatStageFloats, row0, col0, k_dim, c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int wm = (warp / 2) * kMatWarpM, wn = (warp % 2) * kMatWarpN;
  float total[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) total[i][j][e] = 0.0f;
    }
  }
  for (int64_t c = 0; c < chunks; ++c) {
    const int s = static_cast<int>(c % kMatStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kMatStages - 1)
                 : "memory");
    __syncthreads();  // slice c is in stage s, every thread's part
    const float* xs = ring + s * kMatStageFloats;
    const float* ys = xs + kMatTileM * kMatXPitch;
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMatK; kk += 8) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* a = xs + (wm + 16 * i + g) * kMatXPitch + kk + t;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * kMatXPitch], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * kMatXPitch + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* b = ys + (kk + t) * kMatYPitch + wn + 8 * j + g;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4 * kMatYPitch], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_tf32(acc[i][j], al[i], bh[j]);
          mma_tf32(acc[i][j], ah[i], bl[j]);
          mma_tf32(acc[i][j], ah[i], bh[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) total[i][j][e] += acc[i][j][e];
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (c + kMatStages < chunks) {
      stage_slice(x, y, ring + s * kMatStageFloats, row0, col0, k_dim,
                  c + kMatStages);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float* o = out + (row0 + wm + 16 * i + g) * kLanes + col0 + wn +
                 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o) =
          make_float2(total[i][j][0], total[i][j][1]);
      *reinterpret_cast<float2*>(o + 8 * kLanes) =
          make_float2(total[i][j][2], total[i][j][3]);
    }
  }
}

// The dynamic shared memory cudaFuncSetAttribute last granted one kernel
// on each device (0: not asked yet); it only grows.
struct Grant {
  std::atomic<int> bytes[kMaxDevices];
  std::mutex lock;
};

Grant bulk_grant;
Grant matmul_grant;

// Opt `kernel` in to `smem_bytes` of dynamic shared memory on the current
// device, asking only when that is more than it last granted there. A
// refusal is cleared (cudaGetLastError) and returned.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, Grant& grant, int64_t smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* granted =
      dev < kMaxDevices ? &grant.bytes[dev] : nullptr;
  if (granted && smem_bytes <= granted->load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  if (smem_bytes > INT_MAX) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(grant.lock);
  if (granted && smem_bytes <= granted->load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (granted) {
    granted->store(static_cast<int>(smem_bytes), std::memory_order_release);
  }
  return cudaSuccess;
}

int launch_rows(const void* x, void* out, dim3 grid, int threads,
                int64_t x_cols, int64_t out_cols, int tile_rows,
                int tile_cols, int span_rows, unsigned out_mul,
                unsigned out_mod, void* stream) {
  const size_t smem_bytes =
      static_cast<size_t>(tile_rows) * tile_cols * sizeof(float);
  fx_copy_rows<<<grid, threads, smem_bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), x_cols,
      out_cols, tile_rows, tile_cols, span_rows, out_mul, out_mod);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F1: x, out f32 [n], 16-byte aligned; one CTA, the whole array one tile.
extern "C" int fx_vmem_overflow(const void* x, void* out, int64_t n,
                                void* stream) {
  const int64_t smem_bytes = n * static_cast<int64_t>(sizeof(float));
  cudaError_t err = opt_in(fx_copy_bulk, bulk_grant, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fx_copy_bulk<<<1, kWholeThreads, static_cast<size_t>(smem_bytes),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// F2: x, out f32 [rows, cols], rows % 100 == 0, cols % 64 == 0, 16-byte
// aligned; a copy a tile row.
extern "C" int fx_misaligned_tile(const void* x, void* out, int64_t rows,
                                  int64_t cols, void* stream) {
  const int64_t tiles = rows / kMisTileRows;
  return launch_rows(
      x, out,
      dim3(static_cast<unsigned>(tiles),
           static_cast<unsigned>(cols / kMisTileCols)),
      kMisTileRows, cols, cols, kMisTileRows, kMisTileCols, 1, 1,
      static_cast<unsigned>(tiles), stream);
}

// F3: x f32 [x_rows, 128] -> out f32 [2 * x_rows, 128], 16-byte aligned,
// out tile 2i, a copy a tile. First sets fill_count spans of fill_width
// bytes, fill_pitch apart from byte fill_offset of out, to 0xFF (an f32
// NaN): the odd out tiles, which the launch never writes (the wrapper
// computes the geometry).
extern "C" int fx_index_gap(const void* x, void* out, int64_t x_rows,
                            int64_t fill_offset, int64_t fill_pitch,
                            int64_t fill_width, int64_t fill_count,
                            void* stream) {
  cudaError_t err = cudaMemset2DAsync(
      static_cast<char*>(out) + fill_offset, static_cast<size_t>(fill_pitch),
      0xFF, static_cast<size_t>(fill_width), static_cast<size_t>(fill_count),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const int64_t tiles = x_rows / kTileRows;
  return launch_rows(x, out, dim3(static_cast<unsigned>(tiles), 1), kLanes,
                     kLanes, kLanes, kTileRows, kLanes, kTileRows, 2,
                     static_cast<unsigned>(2 * tiles), stream);
}

// F4: x f32 [x_rows, 128] -> out f32 [x_rows / 2, 128], 16-byte aligned,
// out tile i % 2, a copy a tile: two CTAs write each of out tiles 0 and
// 1, in no order. First sets fill_bytes bytes of out from byte
// fill_offset to 0xFF (an f32 NaN): the out tiles from 2 on, which the
// launch never writes; none at the fixture's x_rows = 32, where no fill
// call is made (the wrapper computes the geometry).
extern "C" int fx_index_overlap(const void* x, void* out, int64_t x_rows,
                                int64_t fill_offset, int64_t fill_bytes,
                                void* stream) {
  if (fill_bytes > 0) {
    cudaError_t err = cudaMemsetAsync(
        static_cast<char*>(out) + fill_offset, 0xFF,
        static_cast<size_t>(fill_bytes), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const int64_t tiles = x_rows / kTileRows;
  return launch_rows(x, out, dim3(static_cast<unsigned>(tiles), 1), kLanes,
                     kLanes, kLanes, kTileRows, kLanes, kTileRows, 1, 2,
                     stream);
}

// F5: x, out f32 [x_rows, 128], 16-byte aligned.
extern "C" int fx_f64_scratch(const void* x, void* out, int64_t x_rows,
                              void* stream) {
  fx_scratch<<<static_cast<unsigned>(x_rows / kTileRows), kLanes, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// F6: x f32 [m, k_dim], y f32 [k_dim, 128] -> out f32 [m, 128];
// m % kMatTileM == 0, k_dim % 32 == 0, x and y 16-byte aligned.
extern "C" int fx_cost_mismatch(const void* x, const void* y, void* out,
                                int64_t m, int64_t k_dim, void* stream) {
  constexpr int64_t smem_bytes = kMatStages * kMatStageFloats *
                                 static_cast<int64_t>(sizeof(float));
  cudaError_t err = opt_in(fx_matmul_3xtf32, matmul_grant, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fx_matmul_3xtf32<<<dim3(static_cast<unsigned>(m / kMatTileM),
                          kLanes / kMatTileN),
                     kMatThreads, static_cast<size_t>(smem_bytes),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), k_dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int defect_fixtures_last_error() {
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* defect_fixtures_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
