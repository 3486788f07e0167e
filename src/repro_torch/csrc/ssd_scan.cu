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

template <typename V>
int launch(const void* states, const float* decay, const void* h0,
           void* h_prev, void* h_last, int B, int NC, int H, int units,
           cudaStream_t stream) {
  int threads = ((units + 31) / 32) * 32;
  threads = threads > kThreads ? kThreads : threads;
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
