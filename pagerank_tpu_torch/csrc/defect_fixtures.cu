// F1-F6 on Hopper: the seeded-defect fixtures of the kernel-plane check.
//
// Replace the fixtures of pagerank_tpu/analysis/kernels.py:defect_cases
// (the pl.pallas_call sites at :358, :371, :384, :398, :411, :425; bodies
// _fx_copy :330, _fx_scratch :334, _fx_matmul :339). Each fixture is a
// small kernel whose launch geometry trips exactly one rule of
// pagerank_tpu_torch/analysis/kernels.py, and whose function is the JAX
// fixture's, so the card can show the fault the rule names:
//
//   F1 vmem_overflow   fx_copy, x f32 [n] staged whole in dynamic shared
//                      memory by one CTA: at the fixture's n = 8,388,608
//                      that is 33,554,432 bytes, past the 232,448 a block
//                      may use (PTK001), so the launch is refused.
//   F2 misaligned_tile fx_copy over (100, 64) tiles of x, out f32 [200, 128],
//                      one thread per tile row: 100-thread blocks, not a
//                      whole number of warps (PTK002).
//   F3 index_gap       fx_copy over (8, 128) tiles, x [16, 128] -> out
//                      [32, 128], out tile 2i <- x tile i: out tiles 1 and 3
//                      are never written (PTK003).
//   F4 index_overlap   fx_copy, x [32, 128] -> out [16, 128], out tile
//                      i % 2 <- x tile i: two CTAs write each out tile, in
//                      no order (PTK003).
//   F5 f64_scratch     fx_scratch: acc = -acc on a __shared__ double
//                      (8, 128) scratch, out = x, in an f32 case (PTK004).
//   F6 cost_mismatch   fx_matmul: out = x y in f32, x [256, 128], y
//                      [128, 128], a correct kernel registered with the
//                      analytic model {flops 1, bytes 1} (PTK005).
//
// Bound: device-memory bytes for the copies (each input read once, each
// output written once); F6 does 8.4 MFLOP on 384 KiB, also below the
// card's ridge point. The fixtures exist to be checked, not to be fast:
// fx_copy stages its tile through dynamic shared memory as the TPU staged
// a block through VMEM, and fx_matmul is a plain shared-memory-tiled FMA
// product (each thread an 8 x 8 register tile), not a tensor-core kernel.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the CUDA error of its launch. fx_copy's
// entry points first opt in to their dynamic shared memory with
// cudaFuncSetAttribute; when that is refused (F1 at its geometry) they
// clear the error with cudaGetLastError, so it does not reach the next
// launch's check, and return it without launching.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kTileRows = 8;         // F3-F5: (8, 128) f32 tiles
constexpr int kWholeThreads = 1024;  // F1: one CTA stages the whole array
constexpr int kMisTileRows = 100;    // F2: (100, 64) tiles, one thread a row
constexpr int kMisTileCols = 64;
constexpr int kMatTile = 128;        // F6: 128 x 128 output tile per CTA
constexpr int kMatK = 32;            // F6: depth of one shared-memory step
constexpr int kMatThreads = 256;     // F6: 16 x 16 threads, 8 x 8 outputs each

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

// One (8, 128) tile per CTA, one thread per lane. The scratch is volatile
// so the compiler keeps it, as the TPU kept its VMEM scratch.
__global__ void __launch_bounds__(kLanes)
fx_scratch(const float* __restrict__ x, float* __restrict__ out) {
  volatile __shared__ double acc[kTileRows][kLanes];
  const int lane = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileRows * kLanes;
  for (int r = 0; r < kTileRows; ++r) {
    acc[r][lane] = -acc[r][lane];
    out[base + r * kLanes + lane] = x[base + r * kLanes + lane];
  }
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

int launch_copy(const void* x, void* out, dim3 grid, int threads,
                int64_t x_cols, int64_t out_cols, int64_t tile_rows,
                int64_t tile_cols, int64_t out_mul, int64_t out_mod,
                void* stream) {
  const int64_t smem_bytes =
      tile_rows * tile_cols * static_cast<int64_t>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fx_copy, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  fx_copy<<<grid, threads, static_cast<size_t>(smem_bytes),
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), x_cols, out_cols,
      tile_rows, tile_cols, out_mul, out_mod);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// F1: x, out f32 [n], one CTA, the whole array one tile.
extern "C" int fx_vmem_overflow(const void* x, void* out, int64_t n,
                                void* stream) {
  return launch_copy(x, out, dim3(1, 1), kWholeThreads, n, n, 1, n, 1, 1,
                     stream);
}

// F2: x, out f32 [rows, cols], rows % 100 == 0, cols % 64 == 0.
extern "C" int fx_misaligned_tile(const void* x, void* out, int64_t rows,
                                  int64_t cols, void* stream) {
  return launch_copy(
      x, out,
      dim3(static_cast<unsigned>(rows / kMisTileRows),
           static_cast<unsigned>(cols / kMisTileCols)),
      kMisTileRows, cols, cols, kMisTileRows, kMisTileCols, 1, rows, stream);
}

// F3: x f32 [x_rows, 128] -> out f32 [2 * x_rows, 128], out tile 2i.
extern "C" int fx_index_gap(const void* x, void* out, int64_t x_rows,
                            void* stream) {
  const int64_t tiles = x_rows / kTileRows;
  return launch_copy(x, out, dim3(static_cast<unsigned>(tiles), 1), kLanes,
                     kLanes, kLanes, kTileRows, kLanes, 2, 2 * tiles, stream);
}

// F4: x f32 [x_rows, 128] -> out f32 [x_rows / 2, 128], out tile i % 2.
extern "C" int fx_index_overlap(const void* x, void* out, int64_t x_rows,
                                void* stream) {
  return launch_copy(x, out,
                     dim3(static_cast<unsigned>(x_rows / kTileRows), 1),
                     kLanes, kLanes, kLanes, kTileRows, kLanes, 1, 2, stream);
}

// F5: x, out f32 [x_rows, 128].
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
