// Fused projected-Adam steps of the CR1/CR2 augmented Lagrangian, for Hopper.
//
// Replaces the Pallas TPU kernel `_al_step_kernel`
// (src/repro/kernels/al_step/kernel.py:41). One call runs `k_steps` steps
// on every workload row: the analytic gradient (RTS cubic, or the hinged
// batch queue-integral penalty), the CR1 fixed weight or the CR2
// multiplier form, bias-corrected Adam with 1 - exp(t*log(beta)), then the
// Euclidean projection onto the box and, on batch rows, zero day sums, by
// variable fixing (the plain version finds the same point by a breakpoint
// search, `project_days` in repro_torch/core/fleet_solver.py; the JAX
// package's kernel takes 3 rounds of day-mean removal). Hinges
// take autodiff's derivative of max(c, 0), one half at an exact tie, as
// the generic engine does. Layouts (`rowp` (W, 12), `scal` (1, 8)) are
// documented in repro_torch/kernels/al_step/ref.py.
//
// Bound: at the main path's call (k_steps = 8) the bytes (7 (W, T) f32
// reads plus rowp, 3 writes) outweigh the float operations (~44 per RTS
// hour and step, ~56 per batch hour and step with one projection pass) on
// an H100. Design: one warp per row; the row's x, m, v
// and constants live in registers for all k steps, so x and the moments
// never touch memory between steps. Cumsums are warp scans, the hinge
// indicators' reversed cumsums exact ballot counts, day sums masked warp
// sums. The branch on the row kind, and every projection pass's stop test
// (on butterfly sums, which every lane holds bit for bit), are
// warp-uniform. `scal` is read on the
// device, so mu and the Adam step count t0 cost the host no sync. Moments
// are stored as float or bf16 (template parameter), with float arithmetic.
#include <cuda_bf16.h>

#include "row_scan.cuh"

namespace {

using rowscan::Row2;

constexpr int kThreads = 256;  // 8 rows per block
constexpr int kRowp = 12;

struct Params {
  int W, T, mode, k_steps, day_hours, cvec_stride;
  float beta1, beta2, omb1, omb2, eps;
};

__device__ __forceinline__ float load_moment(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_moment(const __nv_bfloat16* p,
                                             size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_moment(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_moment(__nv_bfloat16* p, size_t i,
                                             float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Projects the hours of one day (slots where `ia` / `ib`) of y onto
// {lo <= x <= hi, sum x = 0} and writes them to xa / xb. Variable fixing:
// shift the free hours so that the day sums to 0, then fix at its bound
// every free hour past the side (lo or hi) that overshoots more, until
// neither or both overshoot alike. A pass that does not stop fixes an
// hour, so a day takes at most day_hours + 1 passes.
__device__ __forceinline__ void project_day(bool ia, bool ib, float ya,
                                            float yb, float loa, float lob,
                                            float hia, float hib, int max_pass,
                                            float& xa, float& xb) {
  int fix_a = 0, fix_b = 0;  // -1: at lo, +1: at hi, 0: free
  float tau = 0.f;
  for (int pass = 0; pass < max_pass; ++pass) {
    const bool fa = ia && fix_a == 0, fb = ib && fix_b == 0;
    const int n = __popc(__ballot_sync(rowscan::kFull, fa)) +
                  __popc(__ballot_sync(rowscan::kFull, fb));
    if (n == 0) break;
    const float ha = fa ? ya : (fix_a < 0 ? loa : hia);
    const float hb = fb ? yb : (fix_b < 0 ? lob : hib);
    tau = rowscan::warp_sum((ia ? ha : 0.f) + (ib ? hb : 0.f)) /
          static_cast<float>(n);
    const float za = ya - tau, zb = yb - tau;
    const float d_lo = rowscan::warp_sum((fa ? fmaxf(loa - za, 0.f) : 0.f) +
                                         (fb ? fmaxf(lob - zb, 0.f) : 0.f));
    const float d_hi = rowscan::warp_sum((fa ? fmaxf(za - hia, 0.f) : 0.f) +
                                         (fb ? fmaxf(zb - hib, 0.f) : 0.f));
    if (d_lo == d_hi) break;
    if (d_lo > d_hi) {
      if (fa && za <= loa) fix_a = -1;
      if (fb && zb <= lob) fix_b = -1;
    } else {
      if (fa && za >= hia) fix_a = 1;
      if (fb && zb >= hib) fix_b = 1;
    }
  }
  if (ia) xa = fix_a < 0 ? loa : (fix_a > 0 ? hia : clip(ya - tau, loa, hia));
  if (ib) xb = fix_b < 0 ? lob : (fix_b > 0 ? hib : clip(yb - tau, lob, hib));
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
al_step_kernel(const float* __restrict__ x_in, const M* __restrict__ m_in,
               const M* __restrict__ v_in, const float* __restrict__ usage,
               const float* __restrict__ jobs, const float* __restrict__ lo_in,
               const float* __restrict__ hi_in,
               const float* __restrict__ rowp, const float* __restrict__ cvec,
               const float* __restrict__ scal, float* __restrict__ x_out,
               M* __restrict__ m_out, M* __restrict__ v_out, Params p) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= p.W) return;
  const int lane = rowscan::lane_id();
  const size_t base = static_cast<size_t>(row) * p.T;
  const size_t ia = base + lane, ib = base + lane + 32;
  const bool va = lane < p.T, vb = lane + 32 < p.T;

  float xa = va ? x_in[ia] : 0.f, xb = vb ? x_in[ib] : 0.f;
  float ma = va ? load_moment(m_in, ia) : 0.f;
  float mb = vb ? load_moment(m_in, ib) : 0.f;
  float sa = va ? load_moment(v_in, ia) : 0.f;
  float sb = vb ? load_moment(v_in, ib) : 0.f;
  const float inv_ua = 1.f / (va ? usage[ia] : 1.f);
  const float inv_ub = 1.f / (vb ? usage[ib] : 1.f);
  const float jua = (va ? jobs[ia] : 0.f) * inv_ua;
  const float jub = (vb ? jobs[ib] : 0.f) * inv_ub;
  const float loa = va ? lo_in[ia] : 0.f, lob = vb ? lo_in[ib] : 0.f;
  const float hia = va ? hi_in[ia] : 0.f, hib = vb ? hi_in[ib] : 0.f;
  const float* crow = cvec + static_cast<size_t>(row) * p.cvec_stride;
  const float ca = va ? crow[lane] : 0.f, cb = vb ? crow[lane + 32] : 0.f;

  const float* rp = rowp + static_cast<size_t>(row) * kRowp;
  const float a3 = rp[0], a2 = rp[1], a1 = rp[2];
  const float b0 = rp[3], b1 = rp[4], b2 = rp[5];
  const float kk = rp[6];
  const bool wait_sq = rp[7] > 0.5f, batch = rp[8] > 0.5f;
  const float refs = rp[9], lam_eq = rp[10], stepw = rp[11];
  const float coef0 = scal[0], mu = scal[1], inv_scale = scal[2];
  const float lr_scale = scal[3], t0 = scal[4];
  const float lb1 = logf(p.beta1), lb2 = logf(p.beta2);

  const int n_days = max(1, p.T / p.day_hours);
  const int span = n_days * p.day_hours;
  const int day_a = lane < span ? lane / p.day_hours : -1;
  const int day_b = lane + 32 < span ? (lane + 32) / p.day_hours : -1;

  for (int i = 0; i < p.k_steps; ++i) {
    float pen = 0.f, ga, gb;
    if (batch) {
      // pen = k*max(b0 + b1*wait_power + b2*x2, 0), x2 = wait_sq | njobs.
      const Row2 c1 = rowscan::row_cumsum({xa, xb});
      const Row2 c2 = rowscan::row_cumsum(
          {jua * xa * fabsf(xa), jub * xb * fabsf(xb)});
      const float x1 = rowscan::row_pos_sum(c1, va, vb);
      const float x2 = wait_sq
          ? rowscan::row_pos_sum(c2, va, vb)
          : rowscan::row_sum({jua * fmaxf(xa, 0.f), jub * fmaxf(xb, 0.f)},
                             va, vb);
      const float z = b0 + b1 * x1 + b2 * x2;
      pen = kk * fmaxf(z, 0.f);
      const Row2 g1 = rowscan::row_revhinge(c1, va, vb);
      float gxa, gxb;
      if (wait_sq) {
        const Row2 r2 = rowscan::row_revhinge(c2, va, vb);
        gxa = 2.f * jua * fabsf(xa) * r2.a;
        gxb = 2.f * jub * fabsf(xb) * r2.b;
      } else {
        gxa = jua * rowscan::hinge(xa);
        gxb = jub * rowscan::hinge(xb);
      }
      const float kz = kk * rowscan::hinge(z);
      ga = kz * (b1 * g1.a + b2 * gxa);
      gb = kz * (b1 * g1.b + b2 * gxb);
    } else {
      // pen = k*sum(a3*delta^3 + a2*delta^2 + a1*delta), delta = x/usage.
      const float da = xa * inv_ua, db = xb * inv_ub;
      if (p.mode == 1) {
        const float fa = a3 * (da * da * da) + a2 * (da * da) + a1 * da;
        const float fb = a3 * (db * db * db) + a2 * (db * db) + a1 * db;
        pen = kk * rowscan::row_sum({fa, fb}, va, vb);
      }
      ga = kk * (3.f * a3 * (da * da) + 2.f * a2 * da + a1) * inv_ua;
      gb = kk * (3.f * a3 * (db * db) + 2.f * a2 * db + a1) * inv_ub;
    }
    float coef = coef0;
    if (p.mode == 1) {
      // dL/dpen for L = obj + lam_eq*h + (mu/2)*h^2, h = (pen - refs)/scale.
      const float h = (pen - refs) * inv_scale;
      coef = (lam_eq + mu * h) * inv_scale;
    }
    ga = coef * ga + ca;
    gb = coef * gb + cb;

    const float t = t0 + static_cast<float>(i + 1);
    const float bc1 = 1.f - expf(t * lb1), bc2 = 1.f - expf(t * lb2);
    ma = p.beta1 * ma + p.omb1 * ga;
    mb = p.beta1 * mb + p.omb1 * gb;
    sa = p.beta2 * sa + p.omb2 * ga * ga;
    sb = p.beta2 * sb + p.omb2 * gb * gb;
    const float step = lr_scale * stepw;
    const float ya = xa - step * (ma / bc1) / (sqrtf(sa / bc2) + p.eps);
    const float yb = xb - step * (mb / bc1) / (sqrtf(sb / bc2) + p.eps);
    // The box; on batch rows each whole day is then projected exactly.
    xa = clip(ya, loa, hia);
    xb = clip(yb, lob, hib);
    if (batch) {
      for (int d = 0; d < n_days; ++d)
        project_day(day_a == d, day_b == d, ya, yb, loa, lob, hia, hib,
                    p.day_hours + 1, xa, xb);
    }
  }

  if (va) {
    x_out[ia] = xa;
    store_moment(m_out, ia, ma);
    store_moment(v_out, ia, sa);
  }
  if (vb) {
    x_out[ib] = xb;
    store_moment(m_out, ib, mb);
    store_moment(v_out, ib, sb);
  }
}

template <typename M>
int launch(const float* x, const void* m, const void* v, const float* usage,
           const float* jobs, const float* lo, const float* hi,
           const float* rowp, const float* cvec, const float* scal,
           float* x_out, void* m_out, void* v_out, const Params& p,
           cudaStream_t stream) {
  const int blocks = (p.W * 32 + kThreads - 1) / kThreads;
  al_step_kernel<M><<<blocks, kThreads, 0, stream>>>(
      x, static_cast<const M*>(m), static_cast<const M*>(v), usage, jobs, lo,
      hi, rowp, cvec, scal, x_out, static_cast<M*>(m_out),
      static_cast<M*>(v_out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int al_step_launch(const float* x, const void* m, const void* v,
                              const float* usage, const float* jobs,
                              const float* lo, const float* hi,
                              const float* rowp, const float* cvec,
                              int cvec_stride, const float* scal,
                              float* x_out, void* m_out, void* v_out, int W,
                              int T, int mode, int k_steps, int day_hours,
                              float beta1, float beta2, float omb1, float omb2,
                              float eps, int bf16_moments, void* stream) {
  const Params p{W,     T,     mode, k_steps, day_hours, cvec_stride,
                 beta1, beta2, omb1, omb2,    eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_moments)
    return launch<__nv_bfloat16>(x, m, v, usage, jobs, lo, hi, rowp, cvec,
                                 scal, x_out, m_out, v_out, p, s);
  return launch<float>(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal, x_out,
                       m_out, v_out, p, s);
}
