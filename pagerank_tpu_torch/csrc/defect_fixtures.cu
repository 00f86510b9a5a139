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
//   F4 index_overlap   fx_copy, x [32, 128] -> out [16, 128], out tile
//                      i % 2 <- x tile i: two CTAs write each out tile, in
//                      no order (PTK003).
//   F5 f64_scratch     fx_scratch: acc = -acc on a __shared__ double
//                      (8, 128) scratch, out = x moved as float4, in an
//                      f32 case (PTK004).
//   F6 cost_mismatch   fx_matmul: out = x y in f32, x [256, 128], y
//                      [128, 128], a correct kernel registered with the
//                      analytic model {flops 1, bytes 1} (PTK005).
//
// Bound: device-memory bytes for the copies (each input read once, each
// output written once); F6 does 8.4 MFLOP on 384 KiB, also below the
// card's ridge point. At the fixtures' KiB shapes a call is its launch,
// so the design keeps the launch and the device work short: F1 stages
// the array through shared memory as the TPU staged its block through
// VMEM, but with Hopper's bulk asynchronous copies (one thread issues a
// global -> shared copy that completes on an mbarrier, then a shared ->
// global bulk group); F2 and F3 move each tile the same way, so a CTA's
// loads are all in flight at once and no thread computes an element's
// index: F2 a copy a 256-byte tile row, each by its own thread; F3's
// (8, 128) tile is one contiguous 4 KiB span in x and in out, so one
// thread moves it with one copy each way, not eight. F5 moves its
// (8, 128) tile as 16-byte vectors. F4 keeps fx_copy, which moves
// 4-byte elements through shared memory one per thread, and fx_matmul
// is a plain shared-memory-tiled FMA product (each thread an 8 x 8
// register tile), not a tensor-core kernel.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the CUDA error of its launch (F3 first
// that of its NaN fill, a cudaMemset2DAsync on the same stream). F1 and
// F4 first opt their kernel in to its dynamic shared memory with
// cudaFuncSetAttribute, asked only when the request is more than the
// current device last granted; when that is refused (F1 at its geometry)
// they clear the error with cudaGetLastError, so it does not reach the
// next launch's check, and return it without launching. F2 and F3 stage
// at most 25,600 bytes, under the 48 KB a block gets without asking. F1,
// F2, F3 and F5 need x and out 16-byte aligned (their wrappers check).

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
constexpr int kMatTile = 128;        // F6: 128 x 128 output tile per CTA
constexpr int kMatK = 32;            // F6: depth of one shared-memory step
constexpr int kMatThreads = 256;     // F6: 16 x 16 threads, 8 x 8 outputs each
constexpr int kVec = 4;              // F1, F5: floats in a 16-byte vector
constexpr int kMaxDevices = 64;

// Tile (i, j) of x -> dynamic shared memory -> tile ((out_mul*i) % out_mod,
// j) of out. Tiles are tile_rows x tile_cols of row-major arrays whose rows
// are x_cols and out_cols wide.
__global__ void __launch_bounds__(kWholeThreads)
fx_copy(const float* __restrict__ x, float* __restrict__ out, int64_t x_cols,
        int64_t out_cols, int64_t tile_rows, int64_t tile_cols,
        int64_t out_mul, int64_t out_mod) {
  extern __shared__ float tile[];
  const int64_t i = blockIdx.x;
  const int64_t j = blockIdx.y;
  const int64_t oi = (out_mul * i) % out_mod;
  const int64_t elems = tile_rows * tile_cols;
  for (int64_t e = threadIdx.x; e < elems; e += blockDim.x) {
    const int64_t r = e / tile_cols, c = e % tile_cols;
    tile[e] = x[(i * tile_rows + r) * x_cols + j * tile_cols + c];
  }
  __syncthreads();
  for (int64_t e = threadIdx.x; e < elems; e += blockDim.x) {
    const int64_t r = e / tile_cols, c = e % tile_cols;
    out[(oi * tile_rows + r) * out_cols + j * tile_cols + c] = tile[e];
  }
}

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

// F2, F3: tile (i, j) of x -> dynamic shared memory -> tile ((out_mul*i) %
// out_mod, j) of out, tiles tile_rows x tile_cols of row-major arrays whose
// rows are x_cols and out_cols wide, by bulk copies of span_rows tile rows
// each (span_rows divides tile_rows; a span of more than one row is
// contiguous only where tile_cols == x_cols == out_cols). Thread 0 arms the
// mbarrier `staged` with the tile's bytes; after the block's barrier
// thread s copies span s global -> shared, completing on `staged`; each
// thread with a span waits for the whole tile, then stores its span shared
// -> global as a bulk group and waits for its reads of shared memory
// before it exits. x and out are 16-byte aligned, and a span's bytes and
// offsets are multiples of 16.
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

// out[128 rows of CTA i] = x[rows] y; x [m, k_dim], y [k_dim, 128],
// k_dim % kMatK == 0. Each output is one fmaf chain over k in order.
__global__ void __launch_bounds__(kMatThreads)
fx_matmul(const float* __restrict__ x, const float* __restrict__ y,
          float* __restrict__ out, int64_t k_dim) {
  __shared__ float xs[kMatTile][kMatK];
  __shared__ float ys[kMatK][kMatTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kMatTile;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  }
  for (int64_t k0 = 0; k0 < k_dim; k0 += kMatK) {
    for (int e = threadIdx.x; e < kMatTile * kMatK; e += kMatThreads) {
      xs[e / kMatK][e % kMatK] = x[(row0 + e / kMatK) * k_dim + k0 + e % kMatK];
      ys[e / kMatTile][e % kMatTile] =
          y[(k0 + e / kMatTile) * kMatTile + e % kMatTile];
    }
    __syncthreads();
    for (int k = 0; k < kMatK; ++k) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          acc[a][b] = fmaf(xs[ty + 16 * a][k], ys[k][tx + 16 * b], acc[a][b]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      out[(row0 + ty + 16 * a) * kMatTile + tx + 16 * b] = acc[a][b];
    }
  }
}

// The dynamic shared memory cudaFuncSetAttribute last granted one kernel
// on each device (0: not asked yet); it only grows.
struct Grant {
  std::atomic<int> bytes[kMaxDevices];
  std::mutex lock;
};

Grant copy_grant;
Grant bulk_grant;

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

int launch_copy(const void* x, void* out, dim3 grid, int threads,
                int64_t x_cols, int64_t out_cols, int64_t tile_rows,
                int64_t tile_cols, int64_t out_mul, int64_t out_mod,
                void* stream) {
  const int64_t smem_bytes =
      tile_rows * tile_cols * static_cast<int64_t>(sizeof(float));
  cudaError_t err = opt_in(fx_copy, copy_grant, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fx_copy<<<grid, threads, static_cast<size_t>(smem_bytes),
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), x_cols, out_cols,
      tile_rows, tile_cols, out_mul, out_mod);
  return static_cast<int>(cudaGetLastError());
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

// F4: x f32 [x_rows, 128] -> out f32 [x_rows / 2, 128], out tile i % 2.
extern "C" int fx_index_overlap(const void* x, void* out, int64_t x_rows,
                                void* stream) {
  return launch_copy(x, out,
                     dim3(static_cast<unsigned>(x_rows / kTileRows), 1),
                     kLanes, kLanes, kLanes, kTileRows, kLanes, 1, 2, stream);
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
// m % 128 == 0, k_dim % 32 == 0.
extern "C" int fx_cost_mismatch(const void* x, const void* y, void* out,
                                int64_t m, int64_t k_dim, void* stream) {
  fx_matmul<<<static_cast<unsigned>(m / kMatTile), kMatThreads, 0,
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
