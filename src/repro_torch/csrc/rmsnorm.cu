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
// Bound: bytes. Each row is read once and written once, the scale read
// once: at stablelm-3b's prefill rows (960, 2560) bf16 that is 9.8 MB, 2.94
// us at 3.35 TB/s; there are 4 operations per element, far below the
// card's balance point.
//
// Design: one warp per row (a group of G warps for rows wider than 16
// 16-byte vectors a lane: 4096 bf16 or 2048 f32 elements), R rows a block.
// - The row stays in registers between the sum and the write: lane l
//   holds vectors l, l + 32 G, ... (VPL of them, a compile-time count: 6,
//   10 and 12 at d 1536, 2560 and 3072 in bf16), so x is read from device
//   memory once, with all of a lane's 16-byte loads in flight together.
// - The sum of squares is a warp reduction of f64 shuffles; a group of G >
//   1 warps adds its warps' partial sums, in a fixed order, after one
//   exchange through shared memory.
// - The scale is copied once per block into shared memory (cp.async, so
//   the copies of a block are in flight together with the rows' loads) and
//   read from there by every row of the block.
// - R = min(8 / G, rows per SM rounded up to a power of two): the prefill
//   rows get 8 rows a block (120 blocks at (960, 2560), 384 at mamba2's
//   3072 rows). Few rows spread over more warps: the 8 decode rows take 4
//   (d 1536) or 8 warps each, 2 vectors a lane, one row a block on 8 SMs.
// Rows whose width is no whole number of vectors, or that are not 16-byte
// aligned, take the same design one element at a time. Rows wider than
// 8 x 32 x 16 load units (32768 bf16, 16384 f32, 4096 elements one at a
// time) are refused.
#include <cstdint>

#include <cuda_bf16.h>

#include "kernel_error.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;     // warps a block, at most
constexpr int kMaxVpl = 16;   // load units a lane, at most

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

// The load unit: a 16-byte vector, or one element.
template <typename T, bool VEC> struct Unit { using type = T; };
template <typename T> struct Unit<T, true> { using type = uint4; };

// Global -> shared without a register round trip, so a block's copies are
// all in flight at once: 16 bytes (both addresses 16-byte aligned) or 4.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The V scale values of unit i, from shared memory.
template <int V>
__device__ __forceinline__ void scale_unit(const float* s, int i,
                                           float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(s + i * V)[q];
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = s[i * V + v];
  }
}

// group_warps (G) warps per row, blockDim.x / (32 G) rows per block; the
// dynamic shared memory holds the d scale values.
template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int rows, int d, int group_warps,
               float eps) {
  using U = typename Unit<T, VEC>::type;
  constexpr int V = sizeof(U) / sizeof(T);
  extern __shared__ float4 smem_scale[];
  float* const s_scale = reinterpret_cast<float*>(smem_scale);
  __shared__ double partial[kWarps];

  const int gthreads = 32 * group_warps;
  const int grp = threadIdx.x / gthreads, gl = threadIdx.x - grp * gthreads;
  const int row = blockIdx.x * (blockDim.x / gthreads) + grp;
  const bool live = row < rows;
  const int units = d / V;

  // The row into registers: every load of the lane in flight at once.
  const U* xr = reinterpret_cast<const U*>(x + static_cast<size_t>(row) * d);
  U buf[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = gl + k * gthreads;
    if (live && i < units) buf[k] = xr[i];
  }

  // The scale, once per block, while those loads are in flight.
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0) {
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x)
      cp_async16(smem_scale + i, scale + 4 * i);
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      cp_async4(s_scale + i, scale + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  double ss = 0.0;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = gl + k * gthreads;
    if (live && i < units) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
      double part = 0.0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const double f = to_f32(e[v]);
        part = fma(f, f, part);
      }
      ss += part;
    }
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFull, ss, off);
  if (group_warps > 1 && (threadIdx.x & 31) == 0)
    partial[threadIdx.x >> 5] = ss;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the scale and the partial sums
  if (group_warps > 1) {
    ss = 0.0;
    for (int w = 0; w < group_warps; ++w) ss += partial[grp * group_warps + w];
  }
  if (!live) return;

  const float var = static_cast<float>(ss / d);
  const float r = rsqrtf(var + eps);
  U* yr = reinterpret_cast<U*>(y + static_cast<size_t>(row) * d);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = gl + k * gthreads;
    if (i < units) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
      float sc[V];
      scale_unit<V>(s_scale, i, sc);
      U out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = from_f32<T>((to_f32(e[v]) * r) * sc[v]);
      yr[i] = out;
    }
  }
}

int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

template <typename T, bool VEC, int VPL>
int run(const void* x, const float* scale, void* y, int rows, int d,
        float eps, int group_warps, cudaStream_t stream) {
  const int per_sm = (rows + num_sms() - 1) / num_sms();
  int rpb = 1;
  while (rpb < per_sm && 2 * rpb * group_warps <= kWarps) rpb *= 2;
  const int bytes = d * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_kernel<T, VEC, VPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rmsnorm_kernel<T, VEC, VPL>
      <<<(rows + rpb - 1) / rpb, 32 * group_warps * rpb, bytes, stream>>>(
          static_cast<const T*>(x), scale, static_cast<T*>(y), rows, d,
          group_warps, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch(const void* x, const float* scale, void* y, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  const int units = d / V;
  int g = 1;
  while (units > 32 * g * kMaxVpl && g < kWarps) g *= 2;
  // Few rows (the decode steps' 8): spread each over more warps, while
  // every lane keeps a unit, so that the row's loads and the scale's are
  // in flight on more lanes.
  while (g < kWarps && rows * g < 4 * num_sms() && units >= 64 * g) g *= 2;
  const int vpl = (units + 32 * g - 1) / (32 * g);
  if (vpl <= 1) return run<T, VEC, 1>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 2) return run<T, VEC, 2>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 3) return run<T, VEC, 3>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 4) return run<T, VEC, 4>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 5) return run<T, VEC, 5>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 6) return run<T, VEC, 6>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 8) return run<T, VEC, 8>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 10) return run<T, VEC, 10>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= 12) return run<T, VEC, 12>(x, scale, y, rows, d, eps, g, s);
  if (vpl <= kMaxVpl)
    return run<T, VEC, kMaxVpl>(x, scale, y, rows, d, eps, g, s);
  return static_cast<int>(cudaErrorInvalidValue);  // too wide
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorised: rows are whole 16-byte
// vectors and x, y are 16-byte aligned (the wrapper checks, and refuses
// rows wider than the kernel holds).
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* y,
                              int rows, int d, float eps, int dtype,
                              int vectorised, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vectorised ? launch<float, true>(x, scale, y, rows, d, eps, s)
                      : launch<float, false>(x, scale, y, rows, d, eps, s);
  if (dtype == 1)
    return vectorised
               ? launch<__nv_bfloat16, true>(x, scale, y, rows, d, eps, s)
               : launch<__nv_bfloat16, false>(x, scale, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
