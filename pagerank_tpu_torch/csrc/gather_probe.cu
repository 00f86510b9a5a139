// P1-P3 on Hopper: the gather probe's three kernels.
//
// Replace the Pallas forms of scripts/probe_gather.py:probe_pallas (the
// pl.pallas_call at :148; bodies k_take :169, k_onehot8 :174, k_taa :183).
// All three compute the same function, one output per slot:
//
//     out[r, l] = z[src[r, l]] * w[r, l]
//
// z [n], src int32 [rows, 128], w and out [rows, 128]; z, w and out are all
// float or all bf16. The product is taken in float and, in bf16, rounded to
// nearest even (__float2bfloat16_rn), which is what torch's bf16 multiply
// does, so every kernel is bit-equal to its plain version. Precondition:
// every src value lies in [0, n); the kernels do not check indices.
//
// Bound: device-memory bytes: src (4 bytes a slot), w and out (itemsize
// each) streamed once, z read once. What keeps a kernel off that bound is
// the random gather of z: each one pulls a 32-byte sector for 4 (or 2)
// useful bytes, served by L1 while z is small, by the 50 MB L2 up to
// n ~ 2^23 f32, and by HBM past it. The three kernels differ only in how
// the gather is formed, which is what the probe measures:
//
//   P1 probe_take (k_take, a direct gather): one thread per 4 slots (a warp
//      per slot row): a 16-byte load of src, a 16-byte (f32) or 8-byte
//      (bf16) load of w and store of out, and four 4- or 2-byte __ldg
//      gathers of z through L1/L2.
//   P2 probe_group8 (k_onehot8, read the aligned group of 8 and select one):
//      the same streaming, but each slot reads the whole 8-element group at
//      z + (s & ~7) as vector loads (two 16-byte loads in f32, one in bf16:
//      one 32- or 16-byte piece of a sector) and selects lane s & 7 in
//      registers by a select chain (a dynamic index into a register array
//      would spill to local memory). Needs n % 8 == 0 and z aligned to the
//      group (32 bytes f32, 16 bytes bf16): the wrapper checks both.
//   P3 probe_rowsel_smem (k_taa, a row gather then a select inside the
//      on-chip row): the TPU form's point is a gather served from the
//      on-chip copy of z. On Hopper that copy is shared memory and the
//      select is a bank-addressed load, so: one persistent CTA of 1024
//      threads per SM stages the whole of z into dynamic shared memory with
//      16-byte loads, syncs, then walks the slot quads grid-stride and
//      gathers from shared memory. Carrying the (chunk, 128, 128) row gather
//      over as it is would read 512 bytes a slot. It runs only where
//      n * itemsize <= 232,448 bytes (the opt-in dynamic shared memory of
//      one block): the wrapper checks it.
//
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (P3 also the error of
// its cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // P1, P2: one slot quad per thread
constexpr int kSmemThreads = 1024;   // P3: one CTA per SM, 32 warps
constexpr int kSlotsPerThread = 4;   // one int4 of src
constexpr int kQuadsPerRow = 128 / kSlotsPerThread;

// f32: w and out move 4 slots as one float4.
struct F32 {
  using elem = float;
  using wvec = float4;
  __device__ static float widen(float v) { return v; }
  __device__ static float load(const float* z, int s) { return __ldg(z + s); }
  __device__ static void unpack(const float4& v, float f[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static float4 pack(const float f[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  // The aligned group of 8 holding z[s], as two 16-byte loads, then lane
  // s & 7 by selects.
  __device__ static float pick8(const float* z, int s) {
    const float4* g = reinterpret_cast<const float4*>(z + (s & ~7));
    const float4 lo = __ldg(g);
    const float4 hi = __ldg(g + 1);
    const float4 v = (s & 4) ? hi : lo;
    const int c = s & 3;
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};

// bf16, carried as raw 16 bits: widening is exact (the bits become the
// high half of a float, what __bfloat162float does); w and out move 4
// slots as one uint2, element 0 in the low half of .x.
struct BF16 {
  using elem = uint16_t;
  using wvec = uint2;
  __device__ static float widen(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static float load(const uint16_t* z, int s) {
    return widen(__ldg(z + s));
  }
  __device__ static uint32_t narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ static void unpack(const uint2& v, float f[4]) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  __device__ static uint2 pack(const float f[4]) {
    return make_uint2(narrow(f[0]) | (narrow(f[1]) << 16),
                      narrow(f[2]) | (narrow(f[3]) << 16));
  }
  // The aligned group of 8 holding z[s] is one 16-byte load; the word is
  // chosen by selects, then its half by a shift.
  __device__ static float pick8(const uint16_t* z, int s) {
    const uint4 g = __ldg(reinterpret_cast<const uint4*>(z + (s & ~7)));
    const int c = (s >> 1) & 3;
    const uint32_t word = c == 0 ? g.x : c == 1 ? g.y : c == 2 ? g.z : g.w;
    return __uint_as_float((s & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

template <typename D>
__global__ void __launch_bounds__(kThreads)
probe_take(const typename D::elem* __restrict__ z,
           const int4* __restrict__ src,
           const typename D::wvec* __restrict__ w,
           typename D::wvec* __restrict__ out, int64_t quads) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int4 s = __ldg(src + q);
  float f[4];
  D::unpack(__ldg(w + q), f);
  f[0] = D::load(z, s.x) * f[0];
  f[1] = D::load(z, s.y) * f[1];
  f[2] = D::load(z, s.z) * f[2];
  f[3] = D::load(z, s.w) * f[3];
  out[q] = D::pack(f);
}

template <typename D>
__global__ void __launch_bounds__(kThreads)
probe_group8(const typename D::elem* __restrict__ z,
             const int4* __restrict__ src,
             const typename D::wvec* __restrict__ w,
             typename D::wvec* __restrict__ out, int64_t quads) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int4 s = __ldg(src + q);
  float f[4];
  D::unpack(__ldg(w + q), f);
  f[0] = D::pick8(z, s.x) * f[0];
  f[1] = D::pick8(z, s.y) * f[1];
  f[2] = D::pick8(z, s.z) * f[2];
  f[3] = D::pick8(z, s.w) * f[3];
  out[q] = D::pack(f);
}

template <typename D>
__global__ void __launch_bounds__(kSmemThreads)
probe_rowsel_smem(const typename D::elem* __restrict__ z, int64_t n,
                  const int4* __restrict__ src,
                  const typename D::wvec* __restrict__ w,
                  typename D::wvec* __restrict__ out, int64_t quads) {
  using elem = typename D::elem;
  extern __shared__ __align__(16) unsigned char smem[];
  elem* zs = reinterpret_cast<elem*>(smem);
  // Stage z: 16-byte loads where z is 16-byte aligned, the tail (and a
  // misaligned z) one element at a time.
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(z) & 15) == 0) {
    const int64_t vecs = n * static_cast<int64_t>(sizeof(elem)) / 16;
    const int4* zv = reinterpret_cast<const int4*>(z);
    int4* sv = reinterpret_cast<int4*>(smem);
    for (int64_t i = threadIdx.x; i < vecs; i += kSmemThreads) {
      sv[i] = __ldg(zv + i);
    }
    done = vecs * 16 / static_cast<int64_t>(sizeof(elem));
  }
  for (int64_t i = done + threadIdx.x; i < n; i += kSmemThreads) {
    zs[i] = z[i];
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmemThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kSmemThreads +
                   threadIdx.x;
       q < quads; q += stride) {
    const int4 s = __ldg(src + q);
    float f[4];
    D::unpack(__ldg(w + q), f);
    f[0] = D::widen(zs[s.x]) * f[0];
    f[1] = D::widen(zs[s.y]) * f[1];
    f[2] = D::widen(zs[s.z]) * f[2];
    f[3] = D::widen(zs[s.w]) * f[3];
    out[q] = D::pack(f);
  }
}

template <typename D>
int launch_take(const void* z, const void* src, const void* w, void* out,
                int64_t rows, void* stream) {
  const int64_t quads = rows * kQuadsPerRow;
  const int64_t grid = (quads + kThreads - 1) / kThreads;
  probe_take<D><<<static_cast<unsigned>(grid), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename D::elem*>(z), static_cast<const int4*>(src),
      static_cast<const typename D::wvec*>(w),
      static_cast<typename D::wvec*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
int launch_group8(const void* z, const void* src, const void* w, void* out,
                  int64_t rows, void* stream) {
  const int64_t quads = rows * kQuadsPerRow;
  const int64_t grid = (quads + kThreads - 1) / kThreads;
  probe_group8<D><<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename D::elem*>(z), static_cast<const int4*>(src),
      static_cast<const typename D::wvec*>(w),
      static_cast<typename D::wvec*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
int launch_rowsel(const void* z, int64_t n, const void* src, const void* w,
                  void* out, int64_t rows, void* stream) {
  const int64_t quads = rows * kQuadsPerRow;
  const int64_t smem_bytes =
      (n * static_cast<int64_t>(sizeof(typename D::elem)) + 15) / 16 * 16;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(probe_rowsel_smem<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (quads + kSmemThreads - 1) / kSmemThreads;
  const int64_t grid = needed < sms ? needed : sms;
  probe_rowsel_smem<D><<<static_cast<unsigned>(grid), kSmemThreads,
                         static_cast<size_t>(smem_bytes),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename D::elem*>(z), n,
      static_cast<const int4*>(src), static_cast<const typename D::wvec*>(w),
      static_cast<typename D::wvec*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One signature for all six entry points: (z, n, src, w, out, rows,
// stream); rows > 0. P1 and P2 do not read n.
#define GATHER_PROBE_ENTRY(NAME, BODY)                                        \
  extern "C" int NAME(const void* z, int64_t n, const void* src,              \
                      const void* w, void* out, int64_t rows, void* stream) { \
    (void)n;                                                                  \
    return BODY;                                                              \
  }

GATHER_PROBE_ENTRY(gather_take_f32,
                   launch_take<F32>(z, src, w, out, rows, stream))
GATHER_PROBE_ENTRY(gather_take_bf16,
                   launch_take<BF16>(z, src, w, out, rows, stream))
GATHER_PROBE_ENTRY(gather_group8_f32,
                   launch_group8<F32>(z, src, w, out, rows, stream))
GATHER_PROBE_ENTRY(gather_group8_bf16,
                   launch_group8<BF16>(z, src, w, out, rows, stream))
GATHER_PROBE_ENTRY(gather_rowsel_f32,
                   launch_rowsel<F32>(z, n, src, w, out, rows, stream))
GATHER_PROBE_ENTRY(gather_rowsel_bf16,
                   launch_rowsel<BF16>(z, n, src, w, out, rows, stream))

extern "C" const char* gather_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
