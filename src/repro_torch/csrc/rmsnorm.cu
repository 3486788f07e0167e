// Fused RMSNorm of every row, for Hopper.
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel`
// (src/repro/kernels/rmsnorm/kernel.py:20): for each row of x (N, d),
//   y = (x * rsqrt(mean(x^2) + eps)) * scale
// with x upcast to f32 and y cast back to x's type. scale is (d,) f32 (the
// model's norm scales stay f32). The mean of squares is summed in f64 (each
// f32 square is exact there; the sum's relative error is ~1e-13 at these
// widths) and rounded to f32 once, so it does not depend on the order of
// the sum: the kernel agrees with its plain version (kernels/rmsnorm/ref.py,
// the same rule) bit for bit, whatever the width and the threads per row,
// but where the exact mean lies within that error of an f32 rounding
// boundary. The reference sums in f32; its mean differs by about an ulp.
//
// Bound: bytes. A row is read from device memory once and written once;
// there are 4 operations per element, far below the card's balance point.
// Design: one block per row, one thread per 16-byte vector (8 bf16 or 4
// f32), so the stablelm-3b row (2560 bf16) is 320 threads with one vector
// load each. The sum of squares is a warp-shuffle reduction, then one
// across warps through shared memory. The second pass reads the row again,
// from L1 (the block just read it), and the scale from L2. The TPU
// kernel's (128, d) row tile and its padding copy are gone: rows are
// blocks, and there is no ragged tile to pad. Rows whose width is not a
// whole number of vectors take a scalar loop.
#include <cuda_bf16.h>

#include "kernel_error.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < warps ? red[lane] : 0.0;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int d, float eps, int vectorised) {
  __shared__ double red[32];
  constexpr int V = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  double ss = 0.0;
  if (vectorised) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const double f = to_f32(e[k]);
        ss = fma(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const double f = to_f32(xr[i]);
      ss = fma(f, f, ss);
    }
  }
  const float var = static_cast<float>(block_sum(ss, red) / d);
  const float r = rsqrtf(var + eps);

  if (vectorised) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = from_f32<T>((to_f32(e[k]) * r) * scale[i * V + k]);
      yv[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f32<T>((to_f32(xr[i]) * r) * scale[i]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, int rows, int d,
           float eps, int vectorised, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int units = vectorised ? d / V : d;
  int threads = ((units + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  rmsnorm_kernel<T><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), d, eps,
      vectorised);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorised: rows are whole 16-byte
// vectors and x, y are 16-byte aligned (the wrapper checks).
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* y,
                              int rows, int d, float eps, int dtype,
                              int vectorised, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, y, rows, d, eps, vectorised, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, vectorised, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
