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
// an H100, but a row's steps are chains of dependent collectives, so
// the kernel is bound by latency: it wants few collectives a row and
// every row resident at once. Design:
//   * a group of rowscan::kLanes lanes holds one row (row_scan.cuh), each
//     lane a run of H = ceil(T / kLanes) hours in registers, so a warp
//     carries several rows and one shuffle serves all of them; x, m, v
//     and the row's constants stay in registers for all k steps;
//   * each row kind has its own code (a template parameter): a warp runs
//     the batch code for its batch rows and the RTS code for its RTS rows,
//     each only where it holds a row of that kind, so RTS rows skip the
//     queue-integral scans and the day projection. The fleet interleaves
//     the kinds; `make_fused_inner` (kernels/al_step/ops.py) orders the
//     rows by kind once a solve, batch rows first, so one warp runs both
//     codes and the slower batch blocks start first;
//   * the days of all of a warp's rows are projected together, in one
//     pass loop that ends when every day in the warp has stopped: a pass
//     takes a segmented sum over the days (free hours and held values),
//     then one vote, and the overshoots' segmented sums only where some
//     day overshoots. Where every day is a power of two of whole lanes
//     (24-hour days at T = 48), a day's sum is a lane sum and a
//     butterfly;
//   * the hinges' reversed cumsums are exact float sums of halves, and
//     division and square root take nvcc's fast path without its
//     subnormal slow path (a called subroutine, whose register saves
//     spill).
// Runs load and store as 8-byte pairs where T, H and the operands allow.
// `scal` is read on the device, so mu and the Adam step count t0 cost the
// host no sync. Moments are stored as float or bf16 (template parameter),
// with float arithmetic.
//
// Lanes: one launch runs N independent solves' steps (a sweep's policies
// or an ensemble's scenarios), `blockIdx.y` the lane. Each lane has its
// own x, m, v, rowp and `scal` row (coef0, mu, 1/scale, lr_scale, t0 read
// per lane, never folded into rows, so a lane computes bit for bit what a
// one-lane call on its slices computes); usage, jobs, lo, hi and cvec
// have run-time lane strides, 0 where the lanes share them.
#include <cuda_bf16.h>

#include <cstdint>

#include "row_scan.cuh"

namespace {

using rowscan::kFull;
using rowscan::kLanes;

// 4 warps (64, 128 and 256 threads were timed at 16 lanes a row: PERF.md,
// §6).
constexpr int kThreads = 128;
constexpr int kBlockRows = kThreads / kLanes;
constexpr int kRowp = 12;

struct Params {
  int W, T, mode, k_steps, day_hours, cvec_stride;
  float beta1, beta2, omb1, omb2, eps;
  // Lanes, and each shared-or-not operand's lane stride in elements (x, m,
  // v and their outputs: W * T; rowp: W * kRowp; scal: 8).
  int lanes, ls_usage, ls_jobs, ls_lo, ls_hi, ls_cvec;
};

template <typename M>
struct Operands {
  const float *x, *usage, *jobs, *lo, *hi, *rowp, *cvec, *scal;
  const M *m, *v;
  float* x_out;
  M *m_out, *v_out;
};

// Moments in bf16: pairs as one 4-byte load, rounded once on store.
template <int H>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p, int n,
                                         bool pairs, float (&r)[H],
                                         float fill) {
  if (H % 2 == 0 && pairs) {
#pragma unroll
    for (int h = 0; h < H; h += 2) {
      if (h < n) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p + h));
        r[h] = v.x;
        r[h + 1] = v.y;
      } else {
        r[h] = r[h + 1] = fill;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h)
      r[h] = h < n ? __bfloat162float(p[h]) : fill;
  }
}
template <int H>
__device__ __forceinline__ void load_run(const float* p, int n, bool pairs,
                                         float (&r)[H], float fill) {
  rowscan::load_run<H>(p, n, pairs, r, fill);
}

template <int H>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, int n,
                                          bool pairs, const float (&r)[H]) {
  if (H % 2 == 0 && pairs) {
#pragma unroll
    for (int h = 0; h < H; h += 2)
      if (h < n)
        *reinterpret_cast<__nv_bfloat162*>(p + h) =
            __floats2bfloat162_rn(r[h], r[h + 1]);
  } else {
#pragma unroll
    for (int h = 0; h < H; ++h)
      if (h < n) p[h] = __float2bfloat16(r[h]);
  }
}
template <int H>
__device__ __forceinline__ void store_run(float* p, int n, bool pairs,
                                          const float (&r)[H]) {
  rowscan::store_run<H>(p, n, pairs, r);
}

// NaN stays NaN, as in the plain version's torch.clamp: fmaxf/fminf
// return the other operand for a NaN, a bound, which would hide a
// non-finite step from the sanitizer's check on x (and from the caller).
// max.NaN / min.NaN (sm_80+) differ from max / min only there, and cost
// the same (a select on v != v added ~1 us a call on an H100 at W =
// 10,000).
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}

// y -> x in place. Every hour is clipped to its box; the hours of batch
// days (`in_day`) are projected onto {lo <= x <= hi, each day sums to 0}
// by variable fixing, all the warp's days at once: each pass shifts a
// day's free hours so the day sums to 0, then fixes at its bound every
// free hour past the side (lo or hi) that overshoots more. A day stops
// when it has no free hour or both sides overshoot alike, and keeps its
// shift and fixings while other days go on. A pass that does not stop a
// day fixes one of its hours, so `max_pass` = day_hours + 1 passes end
// every day. Days of any length: segmented sums (row_scan.cuh).
template <int H>
__device__ __forceinline__ void project_days(const rowscan::Segments& days,
                                             unsigned in_day, float (&y)[H],
                                             const float (&lo)[H],
                                             const float (&hi)[H],
                                             int max_pass) {
  unsigned at_lo = 0u, at_hi = 0u, open = in_day;
  float tau[H];
#pragma unroll
  for (int h = 0; h < H; ++h) tau[h] = 0.f;
  for (int pass = 0; pass < max_pass && __any_sync(kFull, open != 0u);
       ++pass) {
    const unsigned fixed = at_lo | at_hi;
    float q[2][H];  // free hours, held values
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool on = open >> h & 1u, free = !(fixed >> h & 1u);
      q[0][h] = on && free ? 1.f : 0.f;
      q[1][h] = on ? (free ? y[h] : ((at_lo >> h & 1u) ? lo[h] : hi[h]))
                   : 0.f;
    }
    rowscan::segment_totals<2, H>(days, q);
    float z[H], d[2][H];  // shifted hours; overshoots below lo, above hi
    bool over = false;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (open >> h & 1u) {
        if (q[0][h] == 0.f)
          open &= ~(1u << h);
        else
          tau[h] = rowscan::div_fast(q[1][h], q[0][h]);
      }
      z[h] = y[h] - tau[h];
      const bool act = (open >> h & 1u) && !(fixed >> h & 1u);
      d[0][h] = act ? rowscan::pos(lo[h] - z[h]) : 0.f;
      d[1][h] = act ? rowscan::pos(z[h] - hi[h]) : 0.f;
      over |= d[0][h] > 0.f || d[1][h] > 0.f;
    }
    // A day none of whose free hours leaves its box after the shift has
    // no overshoot on either side and stops; where that holds for every
    // day of the warp, one vote stands for the overshoots' sums.
    if (!__any_sync(kFull, over)) {
      open = 0u;
      continue;
    }
    rowscan::segment_totals<2, H>(days, d);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (!(open >> h & 1u)) continue;
      const bool free = !(fixed >> h & 1u);
      if (d[0][h] == d[1][h])
        open &= ~(1u << h);
      else if (d[0][h] > d[1][h]) {
        if (free && z[h] <= lo[h]) at_lo |= 1u << h;
      } else if (free && z[h] >= hi[h]) {
        at_hi |= 1u << h;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (!(in_day >> h & 1u))
      y[h] = clip(y[h], lo[h], hi[h]);
    else
      y[h] = (at_lo >> h & 1u)   ? lo[h]
             : (at_hi >> h & 1u) ? hi[h]
                                 : clip(y[h] - tau[h], lo[h], hi[h]);
  }
}

// The same projection where every day is `day_lanes` whole lanes of the
// group (day_hours a multiple of H, day_hours / H a power of two): a
// lane's hours lie in one day or in none (`in_day`), a day's sums are the
// lanes' sums and a butterfly, and a lane keeps one shift and one open
// flag.
template <int H>
__device__ __forceinline__ void project_days_aligned(int day_lanes,
                                                     bool in_day,
                                                     float (&y)[H],
                                                     const float (&lo)[H],
                                                     const float (&hi)[H],
                                                     int max_pass) {
  unsigned at_lo = 0u, at_hi = 0u;
  bool open = in_day;
  float tau = 0.f;
  for (int pass = 0; pass < max_pass && __any_sync(kFull, open); ++pass) {
    const unsigned fixed = at_lo | at_hi;
    float q[2] = {0.f, 0.f};  // free hours, held values
    if (open) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (!(fixed >> h & 1u)) {
          q[0] += 1.f;
          q[1] += y[h];
        } else {
          q[1] += (at_lo >> h & 1u) ? lo[h] : hi[h];
        }
      }
    }
    rowscan::day_lanes_sum<2>(q, day_lanes);
    if (open) {
      if (q[0] == 0.f)
        open = false;
      else
        tau = rowscan::div_fast(q[1], q[0]);
    }
    // As in project_days: one vote where no day of the warp overshoots.
    bool over = false;
    if (open) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float z = y[h] - tau;
        over |= !(fixed >> h & 1u) && (z < lo[h] || z > hi[h]);
      }
    }
    if (!__any_sync(kFull, over)) {
      open = false;
      continue;
    }
    float d[2] = {0.f, 0.f};  // overshoots below lo, above hi
    if (open) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (fixed >> h & 1u) continue;
        const float z = y[h] - tau;
        d[0] += rowscan::pos(lo[h] - z);
        d[1] += rowscan::pos(z - hi[h]);
      }
    }
    rowscan::day_lanes_sum<2>(d, day_lanes);
    if (open) {
      if (d[0] == d[1]) {
        open = false;
      } else {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          if (fixed >> h & 1u) continue;
          const float z = y[h] - tau;
          if (d[0] > d[1]) {
            if (z <= lo[h]) at_lo |= 1u << h;
          } else if (z >= hi[h]) {
            at_hi |= 1u << h;
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (!in_day)
      y[h] = clip(y[h], lo[h], hi[h]);
    else
      y[h] = (at_lo >> h & 1u)   ? lo[h]
             : (at_hi >> h & 1u) ? hi[h]
                                 : clip(y[h] - tau, lo[h], hi[h]);
  }
}

// k_steps steps on `row` (< 0: none) of this lane's group, a batch row
// (kBatch) or an RTS row. kWhole: T fills every lane of a row (T = kLanes
// * H), so no hour of a row needs masking: a slot without a row is a
// whole group, whose zeros reach no other row's reductions. kAlignedDays:
// every day is a power of two of whole lanes (project_days_aligned).
template <int H, bool kAlignedDays, bool kWhole, bool kBatch, typename M>
__device__ __forceinline__ void step_rows(const Operands<M>& o,
                                          const Params& p, int row,
                                          bool pairs) {
  const bool live = row >= 0;
  const int t0 = rowscan::group_lane() * H;
  const int nv = live ? (kWhole ? H : max(0, min(H, p.T - t0))) : 0;
  const unsigned valid = rowscan::low_bits(nv);
  auto on = [&](int h) { return kWhole || (valid >> h & 1u); };
  const size_t off = static_cast<size_t>(live ? row : 0) * p.T + t0;

  float rp[kRowp];
#pragma unroll
  for (int k = 0; k < kRowp; ++k)
    rp[k] = live ? o.rowp[static_cast<size_t>(row) * kRowp + k] : 0.f;
  // The penalty's coefficients: (b0, b1, b2) on batch rows, (a3, a2, a1)
  // on RTS rows.
  const float k0 = kBatch ? rp[3] : rp[0], k1 = kBatch ? rp[4] : rp[1];
  const float k2 = kBatch ? rp[5] : rp[2];
  const bool wait_sq = rp[7] > 0.5f;
  const float kk = rp[6], refs = rp[9], lam_eq = rp[10];
  const float step = o.scal[3] * rp[11];  // lr_scale * step multiplier
  const float coef0 = o.scal[0], mu = o.scal[1], inv_scale = o.scal[2];

  // a: 1/usage on RTS rows, jobs/usage on batch rows.
  float x[H], m[H], s[H], a[H], lo[H], hi[H];
  load_run<H>(o.x + off, nv, pairs, x, 0.f);
  load_run<H>(o.m + off, nv, pairs, m, 0.f);
  load_run<H>(o.v + off, nv, pairs, s, 0.f);
  load_run<H>(o.usage + off, nv, pairs, a, 1.f);
#pragma unroll
  for (int h = 0; h < H; ++h) a[h] = rowscan::div_fast(1.f, a[h]);
  if constexpr (kBatch) {
    float j[H];
    load_run<H>(o.jobs + off, nv, pairs, j, 0.f);
#pragma unroll
    for (int h = 0; h < H; ++h) a[h] = j[h] * a[h];
  }
  load_run<H>(o.lo + off, nv, pairs, lo, 0.f);
  load_run<H>(o.hi + off, nv, pairs, hi, 0.f);
  const float* crow =
      o.cvec + static_cast<size_t>(live ? row : 0) * p.cvec_stride + t0;

  const int span = max(1, p.T / p.day_hours) * p.day_hours;
  rowscan::Segments days{};
  if constexpr (kBatch && !kAlignedDays)
    days = rowscan::day_segments<H>(p.day_hours, span);
  const unsigned in_day = kBatch ? valid & rowscan::low_bits(span - t0) : 0u;

  const float log_beta1 = logf(p.beta1), log_beta2 = logf(p.beta2);
  for (int i = 0; i < p.k_steps; ++i) {
    float rev[2][H];  // batch: reversed hinge cumsums
    float pen, kz = 0.f;
    if constexpr (kBatch) {
      float sums[2] = {0.f, 0.f};  // wait_power, x2
      // pen = k*max(b0 + b1*wait_power + b2*x2, 0), x2 = wait_sq | njobs:
      // the queue integrals' cumsums, then their hinges' reversed cumsums.
#pragma unroll
      for (int h = 0; h < H; ++h) {
        rev[0][h] = x[h];
        rev[1][h] = a[h] * x[h] * fabsf(x[h]);
      }
      rowscan::row_cumsum<2, H>(rev);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (on(h)) {
          sums[0] += rowscan::pos(rev[0][h]);
          sums[1] += wait_sq ? rowscan::pos(rev[1][h])
                             : a[h] * rowscan::pos(x[h]);
        }
        rev[0][h] = on(h) ? rowscan::hinge(rev[0][h]) : 0.f;
        rev[1][h] = on(h) ? rowscan::hinge(rev[1][h]) : 0.f;
      }
      rowscan::row_revcumsum<2, H>(rev);
      rowscan::group_sum<2>(sums);
      const float zz = k0 + k1 * sums[0] + k2 * sums[1];
      pen = kk * rowscan::pos(zz);
      kz = kk * rowscan::hinge(zz);
    } else {
      // pen = k*sum(a3*delta^3 + a2*delta^2 + a1*delta), delta = x/usage;
      // only CR2 reads it.
      float cubic[1] = {0.f};
      if (p.mode == 1) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float d = x[h] * a[h];
          if (on(h)) cubic[0] += k0 * (d * d * d) + k1 * (d * d) + k2 * d;
        }
        rowscan::group_sum<1>(cubic);
      }
      pen = kk * cubic[0];
    }
    float coef = coef0;
    if (p.mode == 1) {
      // dL/dpen for L = obj + lam_eq*h + (mu/2)*h^2, h = (pen - refs)/scale.
      const float hres = (pen - refs) * inv_scale;
      coef = (lam_eq + mu * hres) * inv_scale;
    }

    // Bias corrections 1 - beta^t. The moments are divided by them, as
    // the plain version does: multiplying by their rounded reciprocals
    // scales every hour's step alike, which shifts the CR2 solve at W =
    // 10,000 (rows cloned from four templates) by 0.05 pp of carbon.
    const float t = o.scal[4] + static_cast<float>(i + 1);
    const float bc1 = 1.f - expf(t * log_beta1);
    const float bc2 = 1.f - expf(t * log_beta2);
    float c[H];
    load_run<H>(crow, nv, pairs && p.cvec_stride % 2 == 0, c, 0.f);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float gp;
      if constexpr (kBatch) {
        const float gx = wait_sq ? 2.f * a[h] * fabsf(x[h]) * rev[1][h]
                                 : a[h] * rowscan::hinge(x[h]);
        gp = kz * (k1 * rev[0][h] + k2 * gx);
      } else {
        const float d = x[h] * a[h];
        gp = kk * (3.f * k0 * (d * d) + 2.f * k1 * d + k2) * a[h];
      }
      const float g = coef * gp + c[h];
      m[h] = p.beta1 * m[h] + p.omb1 * g;
      s[h] = p.beta2 * s[h] + p.omb2 * g * g;
      const float mhat = rowscan::div_fast(m[h], bc1);
      const float vhat = rowscan::div_fast(s[h], bc2);
      x[h] = x[h] - rowscan::div_fast(step * mhat,
                                      rowscan::sqrt_fast(vhat) + p.eps);
    }
    // x holds the unprojected step y here; the box, and on batch rows
    // each whole day projected exactly.
    if constexpr (!kBatch) {
#pragma unroll
      for (int h = 0; h < H; ++h) x[h] = clip(x[h], lo[h], hi[h]);
    } else if constexpr (kAlignedDays) {
      project_days_aligned<H>(p.day_hours / H, in_day != 0u, x, lo, hi,
                              p.day_hours + 1);
    } else {
      project_days<H>(days, in_day, x, lo, hi, p.day_hours + 1);
    }
  }

  store_run<H>(o.x_out + off, nv, pairs, x);
  store_run<H>(o.m_out + off, nv, pairs, m);
  store_run<H>(o.v_out + off, nv, pairs, s);
}

// The operands of lane `lane`.
template <typename M>
__device__ __forceinline__ Operands<M> at_lane(Operands<M> o, const Params& p,
                                               int lane) {
  const size_t l = static_cast<size_t>(lane);
  const size_t state = l * p.W * p.T;
  o.x += state;
  o.m += state;
  o.v += state;
  o.x_out += state;
  o.m_out += state;
  o.v_out += state;
  o.usage += l * p.ls_usage;
  o.jobs += l * p.ls_jobs;
  o.lo += l * p.ls_lo;
  o.hi += l * p.ls_hi;
  o.cvec += l * p.ls_cvec;
  o.rowp += l * p.W * kRowp;
  o.scal += l * 8;
  return o;
}

// Launch bounds of at least one block an SM: with the thread count alone
// ptxas aims at an occupancy and spills a few bytes in some
// instantiations.
template <int H, bool kAlignedDays, bool kWhole, typename M>
__global__ void __launch_bounds__(kThreads, 1)
al_step_kernel(const Operands<M> lanes, const Params p, bool pairs) {
  const Operands<M> o = at_lane(lanes, p, blockIdx.y);
  const int r = blockIdx.x * kBlockRows + threadIdx.x / kLanes;
  const int row = r < p.W ? r : -1;
  const bool batch =
      row >= 0 && o.rowp[static_cast<size_t>(row) * kRowp + 8] > 0.5f;
  if (__any_sync(kFull, batch))
    step_rows<H, kAlignedDays, kWhole, true, M>(o, p, batch ? row : -1,
                                                pairs);
  if (__any_sync(kFull, row >= 0 && !batch))
    step_rows<H, kAlignedDays, kWhole, false, M>(o, p, batch ? -1 : row,
                                                 pairs);
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <int H, typename M>
int launch(const Operands<M>& o, const Params& p, cudaStream_t stream) {
  const dim3 blocks((p.W + kBlockRows - 1) / kBlockRows, p.lanes);
  // Pairs stay aligned in every lane where each lane stride is even.
  bool pairs = H % 2 == 0 && p.T % 2 == 0 &&
               (p.lanes == 1 || (p.ls_usage | p.ls_jobs | p.ls_lo | p.ls_hi |
                                 p.ls_cvec) % 2 == 0);
  const void* const f32[] = {o.x, o.usage, o.jobs, o.lo, o.hi, o.cvec,
                             o.x_out};
  const void* const moments[] = {o.m, o.v, o.m_out, o.v_out};
  for (const void* q : f32) pairs = pairs && aligned(q, 8);
  for (const void* q : moments) pairs = pairs && aligned(q, 2 * sizeof(M));
  const int day_lanes = p.day_hours / H;
  const bool aligned_days =
      p.day_hours % H == 0 && (day_lanes & (day_lanes - 1)) == 0;
  if (aligned_days && p.T == kLanes * H)
    al_step_kernel<H, true, true, M>
        <<<blocks, kThreads, 0, stream>>>(o, p, pairs);
  else if (aligned_days)
    al_step_kernel<H, true, false, M>
        <<<blocks, kThreads, 0, stream>>>(o, p, pairs);
  else
    al_step_kernel<H, false, false, M>
        <<<blocks, kThreads, 0, stream>>>(o, p, pairs);
  return static_cast<int>(cudaGetLastError());
}

// The kernel for H = run_length(T), over H = 1 .. kMaxRun.
template <typename M, int H = 1>
int dispatch(const Operands<M>& o, const Params& p, cudaStream_t stream) {
  if constexpr (H > rowscan::kMaxRun) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (rowscan::run_length(p.T) == H) return launch<H, M>(o, p, stream);
    return dispatch<M, H + 1>(o, p, stream);
  }
}

template <typename M>
Operands<M> operands(const float* x, const void* m, const void* v,
                     const float* usage, const float* jobs, const float* lo,
                     const float* hi, const float* rowp, const float* cvec,
                     const float* scal, float* x_out, void* m_out,
                     void* v_out) {
  return {x, usage, jobs, lo, hi, rowp, cvec, scal,
          static_cast<const M*>(m), static_cast<const M*>(v), x_out,
          static_cast<M*>(m_out), static_cast<M*>(v_out)};
}

}  // namespace

// `lanes` solves in one launch; `ls_*` are the lane strides of usage,
// jobs, lo, hi and cvec in elements (0: shared by every lane). x, m, v
// and the outputs are (lanes, W, T), rowp (lanes, W, 12), scal (lanes, 8).
extern "C" int al_step_lanes_launch(
    const float* x, const void* m, const void* v, const float* usage,
    const float* jobs, const float* lo, const float* hi, const float* rowp,
    const float* cvec, int cvec_stride, const float* scal, float* x_out,
    void* m_out, void* v_out, int W, int T, int mode, int k_steps,
    int day_hours, float beta1, float beta2, float omb1, float omb2,
    float eps, int bf16_moments, int lanes, int ls_usage, int ls_jobs,
    int ls_lo, int ls_hi, int ls_cvec, void* stream) {
  if (T < 1 || T > rowscan::kMaxHours || day_hours < 1 || lanes < 1 ||
      lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  day_hours = day_hours < T ? day_hours : T;  // a horizon under a day is one day
  const Params p{W,     T,     mode,     k_steps, day_hours, cvec_stride,
                 beta1, beta2, omb1,     omb2,    eps,       lanes,
                 ls_usage, ls_jobs, ls_lo, ls_hi, ls_cvec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_moments)
    return dispatch(operands<__nv_bfloat16>(x, m, v, usage, jobs, lo, hi,
                                            rowp, cvec, scal, x_out, m_out,
                                            v_out),
                    p, s);
  return dispatch(operands<float>(x, m, v, usage, jobs, lo, hi, rowp, cvec,
                                  scal, x_out, m_out, v_out),
                  p, s);
}

// One lane: the interface of the kernel before it had lanes.
extern "C" int al_step_launch(const float* x, const void* m, const void* v,
                              const float* usage, const float* jobs,
                              const float* lo, const float* hi,
                              const float* rowp, const float* cvec,
                              int cvec_stride, const float* scal,
                              float* x_out, void* m_out, void* v_out, int W,
                              int T, int mode, int k_steps, int day_hours,
                              float beta1, float beta2, float omb1, float omb2,
                              float eps, int bf16_moments, void* stream) {
  return al_step_lanes_launch(x, m, v, usage, jobs, lo, hi, rowp, cvec,
                              cvec_stride, scal, x_out, m_out, v_out, W, T,
                              mode, k_steps, day_hours, beta1, beta2, omb1,
                              omb2, eps, bf16_moments, 1, 0, 0, 0, 0, 0,
                              stream);
}
