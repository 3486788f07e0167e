// Mamba-2 SSD inter-chunk state scan, for Hopper.
//
// Replaces the Pallas TPU kernel `_ssd_scan_kernel`
// (src/repro/kernels/ssd_scan/kernel.py:24). For every (b, h) and every
// element e of the flattened (P, N) state:
//   h_prev[b, c, h, e] = h            (the state before chunk c)
//   h = decay[b, c, h] * h + states[b, c, h, e]
// over c = 0 .. NC-1 from h = h0[b, h, e] (or 0), then h_last[b, h, e] = h.
// Everything is float32; the product and the sum are rounded separately
// (__fmul_rn, __fadd_rn, no fused multiply-add), as the plain version and
// the JAX scan compute them, so the kernel agrees with both bit for bit.
//
// Bound: bytes. Each state element is read once and each h_prev and
// h_last element written once; there are 2 operations per element per
// chunk. Design: the TPU grid (B, H, NC) with a (P, N) carry in VMEM
// scratch and a sequential chunk axis becomes one block per (slice of
// P·N, h, b). Each thread keeps its elements' carry in registers (one
// float4 where the rows are whole, 16-byte aligned vectors, one float
// otherwise) and loops over the chunks. The loads of a group of kAhead
// chunks do not depend on the carry, so they are all issued before the
// group's updates: kAhead loads in flight per thread. The decay is one
// scalar per (b, c, h), the same for the whole block (an L1 broadcast).
//
// The backward kernel runs the same recurrence in reverse, on the same
// grid and with the same register carry. From a = g_last (or 0), for
// c = NC-1 .. 0:
//   dstates[b, c, h, e] = a
//   ddecay[b, c, h]    += a * h_prev[b, c, h, e]   (over every e)
//   a = g_prev[b, c, h, e] + decay[b, c, h] * a
// and dh0[b, h, e] = a at the end. The product and the sum of the carry
// are rounded separately, as autograd forms them through the plain
// version, so dstates and dh0 equal its gradients bit for bit. The decay
// gradient's sum over P·N spans the blocks of a (h, b): each block sums
// its elements' f32 products in double (a warp shuffle, then one shared
// slot per warp) and writes one partial sum per chunk, with no atomics;
// the wrapper adds the blocks' partials, so the result is deterministic.
// Bound: bytes (g_prev and h_prev read once, dstates written once).
#include <cuda_runtime.h>

#include "kernel_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;

__device__ __forceinline__ float step(float h, float d, float s) {
  return __fadd_rn(__fmul_rn(h, d), s);
}
__device__ __forceinline__ float4 step(float4 h, float d, float4 s) {
  return make_float4(step(h.x, d, s.x), step(h.y, d, s.y),
                     step(h.z, d, s.z), step(h.w, d, s.w));
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V = float4 or float; `units` = P·N / (elements per V) per (b, c, h).
template <typename V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const V* __restrict__ states, const float* __restrict__ decay,
                const V* __restrict__ h0, V* __restrict__ h_prev,
                V* __restrict__ h_last, int NC, int H, int units) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= units) return;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t chunk_stride = static_cast<size_t>(H) * units;
  const size_t first = (b * NC * H + h) * units + u;   // (b, c = 0, h, u)
  const float* dec = decay + b * NC * H + h;           // (b, c = 0, h)

  V carry = h0 ? h0[(b * H + h) * units + u] : zero<V>();
  for (int c0 = 0; c0 < NC; c0 += kAhead) {
    V s[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < NC) {
        s[k] = states[first + (c0 + k) * chunk_stride];
        d[k] = dec[static_cast<size_t>(c0 + k) * H];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < NC) {
        h_prev[first + (c0 + k) * chunk_stride] = carry;
        carry = step(carry, d[k], s[k]);
      }
    }
  }
  h_last[(b * H + h) * units + u] = carry;
}

__device__ __forceinline__ float4 scale(float4 a, float d) {
  return make_float4(__fmul_rn(a.x, d), __fmul_rn(a.y, d),
                     __fmul_rn(a.z, d), __fmul_rn(a.w, d));
}
__device__ __forceinline__ float scale(float a, float d) {
  return __fmul_rn(a, d);
}
__device__ __forceinline__ float4 add(float4 g, float4 a) {
  return make_float4(__fadd_rn(g.x, a.x), __fadd_rn(g.y, a.y),
                     __fadd_rn(g.z, a.z), __fadd_rn(g.w, a.w));
}
__device__ __forceinline__ float add(float g, float a) {
  return __fadd_rn(g, a);
}
// The f32 products a · h, summed in double.
__device__ __forceinline__ double dot(float4 a, float4 h) {
  return static_cast<double>(__fmul_rn(a.x, h.x))
       + static_cast<double>(__fmul_rn(a.y, h.y))
       + static_cast<double>(__fmul_rn(a.z, h.z))
       + static_cast<double>(__fmul_rn(a.w, h.w));
}
__device__ __forceinline__ double dot(float a, float h) {
  return static_cast<double>(__fmul_rn(a, h));
}

// partial (gridDim.x, B, NC, H): each block's share of the decay
// gradient. g_prev, g_last and dh0 may be null (zeros; no dh0 wanted).
template <typename V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_bwd_kernel(const V* __restrict__ g_prev, const V* __restrict__ g_last,
                    const float* __restrict__ decay,
                    const V* __restrict__ h_prev, V* __restrict__ dstates,
                    V* __restrict__ dh0, double* __restrict__ partial,
                    int NC, int H, int units) {
  __shared__ double sums[kAhead][kThreads / 32];
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = u < units;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z, B = gridDim.z;
  const size_t chunk_stride = static_cast<size_t>(H) * units;
  const size_t first = (b * NC * H + h) * units + u;   // (b, c = 0, h, u)
  const float* dec = decay + b * NC * H + h;           // (b, c = 0, h)
  double* part = partial + (blockIdx.x * B + b) * NC * H + h;

  V a = (g_last && live) ? g_last[(b * H + h) * units + u] : zero<V>();
  for (int c1 = NC - 1; c1 >= 0; c1 -= kAhead) {
    V g[kAhead], hp[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c1 - k;
      if (c >= 0 && live) {
        hp[k] = h_prev[first + c * chunk_stride];
        g[k] = g_prev ? g_prev[first + c * chunk_stride] : zero<V>();
        d[k] = dec[static_cast<size_t>(c) * H];
      }
    }
    double s[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c1 - k;
      s[k] = 0.0;
      if (c >= 0 && live) {
        dstates[first + c * chunk_stride] = a;
        s[k] = dot(a, hp[k]);
        a = g_prev ? add(g[k], scale(a, d[k])) : scale(a, d[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
      if (lane == 0) sums[k][warp] = s[k];
    }
    __syncthreads();
    const int k = threadIdx.x;
    if (k < kAhead && c1 - k >= 0) {
      double t = 0.0;
      for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
        t += sums[k][w];
      part[static_cast<size_t>(c1 - k) * H] = t;
    }
    __syncthreads();
  }
  if (dh0 && live) dh0[(b * H + h) * units + u] = a;
}

int threads_for(int units) {
  const int threads = ((units + 31) / 32) * 32;
  return threads > kThreads ? kThreads : threads;
}

template <typename V>
int launch_bwd(const void* g_prev, const void* g_last, const float* decay,
               const void* h_prev, void* dstates, void* dh0, double* partial,
               int B, int NC, int H, int units, cudaStream_t stream) {
  const int threads = threads_for(units);
  const dim3 grid((units + threads - 1) / threads, H, B);
  ssd_scan_bwd_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(g_prev), static_cast<const V*>(g_last), decay,
      static_cast<const V*>(h_prev), static_cast<V*>(dstates),
      static_cast<V*>(dh0), partial, NC, H, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch(const void* states, const float* decay, const void* h0,
           void* h_prev, void* h_last, int B, int NC, int H, int units,
           cudaStream_t stream) {
  const int threads = threads_for(units);
  const dim3 grid((units + threads - 1) / threads, H, B);
  ssd_scan_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(states), decay, static_cast<const V*>(h0),
      static_cast<V*>(h_prev), static_cast<V*>(h_last), NC, H, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states (B, NC, H, P, N), decay (B, NC, H), h0 (B, H, P, N) or null,
// h_prev (B, NC, H, P, N), h_last (B, H, P, N): contiguous float32.
// vectorised: P·N is a multiple of 4 and every pointer is 16-byte aligned
// (the wrapper checks), so each (b, c, h) row is whole float4s.
extern "C" int ssd_scan_launch(const void* states, const float* decay,
                               const void* h0, void* h_prev, void* h_last,
                               int B, int NC, int H, int PN, int vectorised,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorised)
    return launch<float4>(states, decay, h0, h_prev, h_last, B, NC, H,
                          PN / 4, s);
  return launch<float>(states, decay, h0, h_prev, h_last, B, NC, H, PN, s);
}

// Blocks along P·N of either kernel's grid: the backward's partial sums
// have this leading extent.
extern "C" int ssd_scan_blocks(int PN, int vectorised) {
  const int units = vectorised ? PN / 4 : PN;
  const int threads = threads_for(units);
  return (units + threads - 1) / threads;
}

// The backward. g_prev (B, NC, H, P, N) or null, g_last (B, H, P, N) or
// null, decay (B, NC, H), h_prev (B, NC, H, P, N) the forward's output,
// dstates (B, NC, H, P, N), dh0 (B, H, P, N) or null: contiguous float32;
// partial (ssd_scan_blocks(PN, vectorised), B, NC, H) float64, each of its
// elements written once.
extern "C" int ssd_scan_bwd_launch(const void* g_prev, const void* g_last,
                                   const float* decay, const void* h_prev,
                                   void* dstates, void* dh0, double* partial,
                                   int B, int NC, int H, int PN,
                                   int vectorised, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vectorised)
    return launch_bwd<float4>(g_prev, g_last, decay, h_prev, dstates, dh0,
                              partial, B, NC, H, PN / 4, s);
  return launch_bwd<float>(g_prev, g_last, decay, h_prev, dstates, dh0,
                           partial, B, NC, H, PN, s);
}
