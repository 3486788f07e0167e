// Table-IV queue-integral features of every workload row, for Hopper.
//
// Replaces the Pallas TPU kernel `_features_kernel`
// (src/repro/kernels/dr_features/kernel.py:26). (W, T) -> (W, 4):
//   [sum max(cumsum(j*d/u), 0), sum max(cumsum(d), 0),
//    sum max(cumsum(j*d*|d|/u), 0), sum j*max(d, 0)/u]
// with a max that keeps NaN, as the plain version's torch.maximum
// (rowscan::pos).
//
// Bound: bytes. Each row reads 3*T floats and writes 4, with about 20
// operations per hour, far below the card's ~20 flop/byte balance point.
// Design: the sub-warp layout of row_scan.cuh, rowscan::kLanes lanes a
// row and a run of H = ceil(T / kLanes) hours a lane, so a warp carries
// several rows and each shuffle of the three cumsums' scans and the four
// sums' butterflies serves all of them. Runs load as 8-byte pairs where T,
// H and the operands allow, and a row's four features leave as one 16-byte
// store. The rates take one reciprocal of usage an hour. Rows past W take
// part in their warp's shuffles with no hour; whole warps past W exit.
#include <cstdint>

#include "row_scan.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps

template <int H>
__global__ void __launch_bounds__(kThreads)
dr_features_kernel(const float* __restrict__ d, const float* __restrict__ u,
                   const float* __restrict__ j, float* __restrict__ out,
                   int W, int T, bool pairs, bool out_vec) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if ((tid >> 5) * rowscan::kRowsPerWarp >= W) return;
  const int row = tid / rowscan::kLanes;
  const bool live = row < W;
  const int g = rowscan::group_lane();
  const int nv = live ? max(0, min(H, T - g * H)) : 0;
  const size_t off = static_cast<size_t>(live ? row : 0) * T + g * H;
  float dd[H], uu[H], jj[H];
  rowscan::load_run<H>(d + off, nv, pairs, dd, 0.f);
  rowscan::load_run<H>(u + off, nv, pairs, uu, 1.f);
  rowscan::load_run<H>(j + off, nv, pairs, jj, 0.f);

  float cs[3][H];  // rate, d, rate_sq
#pragma unroll
  for (int h = 0; h < H; ++h) {
    jj[h] *= rowscan::div_fast(1.f, uu[h]);  // jobs / usage
    cs[0][h] = jj[h] * dd[h];
    cs[1][h] = dd[h];
    cs[2][h] = jj[h] * dd[h] * fabsf(dd[h]);
  }
  rowscan::row_cumsum<3, H>(cs);
  float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (h < nv) {
      f[0] += rowscan::pos(cs[0][h]);
      f[1] += rowscan::pos(cs[1][h]);
      f[2] += rowscan::pos(cs[2][h]);
      f[3] += jj[h] * rowscan::pos(dd[h]);
    }
  }
  rowscan::group_sum<4>(f);

  if (live && g == 0) {
    float* o = out + static_cast<size_t>(row) * 4;
    if (out_vec) {
      *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = f[k];
    }
  }
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <int H>
int launch(const float* d, const float* u, const float* j, float* out, int W,
           int T, cudaStream_t stream) {
  const int warps = (W + rowscan::kRowsPerWarp - 1) / rowscan::kRowsPerWarp;
  const int blocks = (warps * 32 + kThreads - 1) / kThreads;
  const bool pairs = T % 2 == 0 && aligned(d, 8) && aligned(u, 8) &&
                     aligned(j, 8);
  dr_features_kernel<H><<<blocks, kThreads, 0, stream>>>(
      d, u, j, out, W, T, pairs, aligned(out, 16));
  return static_cast<int>(cudaGetLastError());
}

// The kernel for H = run_length(T), over H = 1 .. kMaxRun.
template <int H = 1>
int dispatch(const float* d, const float* u, const float* j, float* out,
             int W, int T, cudaStream_t stream) {
  if constexpr (H > rowscan::kMaxRun) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (rowscan::run_length(T) == H) return launch<H>(d, u, j, out, W, T,
                                                       stream);
    return dispatch<H + 1>(d, u, j, out, W, T, stream);
  }
}

}  // namespace

extern "C" int dr_features_launch(const float* d, const float* u,
                                  const float* j, float* out, int W, int T,
                                  void* stream) {
  return dispatch(d, u, j, out, W, T, static_cast<cudaStream_t>(stream));
}
