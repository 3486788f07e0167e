// Table-IV queue-integral features of every workload row, for Hopper.
//
// Replaces the Pallas TPU kernel `_features_kernel`
// (src/repro/kernels/dr_features/kernel.py:26). (W, T) -> (W, 4):
//   [sum max(cumsum(j*d/u), 0), sum max(cumsum(d), 0),
//    sum max(cumsum(j*d*|d|/u), 0), sum j*max(d, 0)/u]
//
// Bound: bytes. Each row reads 3*T floats and writes 4, with about 20
// operations per hour, far below the card's ~20 flop/byte balance point.
// Design: one warp per row, the whole row in registers (two hours per
// lane), cumsums as warp scans. The TPU tile's padding copy is gone:
// lanes past T are masked, and rows past W exit as whole warps.
#include "row_scan.cuh"

namespace {

using rowscan::Row2;

constexpr int kThreads = 256;  // 8 rows per block

__global__ void __launch_bounds__(kThreads)
dr_features_kernel(const float* __restrict__ d, const float* __restrict__ u,
                   const float* __restrict__ j, float* __restrict__ out,
                   int W, int T) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= W) return;
  const int lane = rowscan::lane_id();
  const size_t base = static_cast<size_t>(row) * T;
  const bool va = lane < T, vb = lane + 32 < T;
  const float da = va ? d[base + lane] : 0.f;
  const float db = vb ? d[base + lane + 32] : 0.f;
  const float ua = va ? u[base + lane] : 1.f;
  const float ub = vb ? u[base + lane + 32] : 1.f;
  const float ja = va ? j[base + lane] : 0.f;
  const float jb = vb ? j[base + lane + 32] : 0.f;

  const Row2 rate = {ja * da / ua, jb * db / ub};
  const Row2 rate_sq = {ja * da * fabsf(da) / ua, jb * db * fabsf(db) / ub};
  const float wait_jobs = rowscan::row_pos_sum(rowscan::row_cumsum(rate), va, vb);
  const float wait_power =
      rowscan::row_pos_sum(rowscan::row_cumsum({da, db}), va, vb);
  const float wait_sq =
      rowscan::row_pos_sum(rowscan::row_cumsum(rate_sq), va, vb);
  const float njobs = rowscan::row_sum(
      {ja * fmaxf(da, 0.f) / ua, jb * fmaxf(db, 0.f) / ub}, va, vb);

  if (lane < 4) {
    const float v = lane == 0 ? wait_jobs
                  : lane == 1 ? wait_power
                  : lane == 2 ? wait_sq : njobs;
    out[static_cast<size_t>(row) * 4 + lane] = v;
  }
}

}  // namespace

extern "C" int dr_features_launch(const float* d, const float* u,
                                  const float* j, float* out, int W, int T,
                                  void* stream) {
  const int blocks = (W * 32 + kThreads - 1) / kThreads;
  dr_features_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(d, u, j, out, W, T);
  return static_cast<int>(cudaGetLastError());
}
