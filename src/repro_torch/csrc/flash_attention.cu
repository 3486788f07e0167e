// Flash attention forward (FA2-style online softmax), for Hopper.
//
// Replaces the Pallas TPU kernel `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py:28). In the model's layout,
// q (B, Sq, H, Dh), k (B, Skv, KV, Dh), v (B, Skv, KV, Dv) -> o (B, Sq, H,
// Dv), with H % KV == 0 (query head h reads kv head h / (H / KV)), scores
// scaled by 1/sqrt(Dh), and causal masking of key position j > q_offset + i
// for query row i (the finite mask value -1e30). Running max, denominator
// and accumulator are f32. Keys past Skv and queries past Sq are masked or
// left unwritten, so there is no padding copy; blocks wholly above the
// causal diagonal are never loaded. One launch per call.
//
// Training passes a (B, H, Sq) f32 buffer that takes each query row's
// log-sum-exp of its scaled scores, scale * max + log(sum), written once
// from the registers that already hold both; the backward
// (kernels/flash_attention/grad.py) recomputes P from it. Serving passes
// none, and the output is the same bits either way.
//
// Bound: at stablelm-3b's prefill (q/k/v (8, 120, 32, 80) bf16, causal) the
// products are ~1 GFLOP, ~1 us at the bf16 tensor-core peak, and the bytes
// (q, k, v and o once each, 9.8 MB) bound the call at 5.87 us.
//
// bfloat16 (the serving path), `fa_bf16_kernel`: one block of 8 warps per
// (128 query rows, head, batch); each warp owns 16 query rows, so a row's
// max and sum never leave its warp.
// - Both products run on the tensor cores, mma.sync m16n8k16 bf16 -> f32.
//   Q's A fragments are loaded once per block (ldmatrix) and kept in
//   registers; K's B fragments come by ldmatrix, V's by ldmatrix.trans.
// - The online softmax runs on the accumulator fragments: a row lives on
//   the 4 lanes of a quad, so its max is 2 shuffles and its sum is kept
//   per lane until the end; max and sum are trees, not chains. Only a kv
//   block on the warp's diagonal, or at the Skv tail, evaluates the mask,
//   and there the tiles of 8 keys past the warp's last live key are
//   skipped (a warp with none skips the block's products).
// - P never leaves the registers: the m16n8 f32 accumulator layout is,
//   pairwise, the m16n8k16 A layout, so P is rounded to bf16 in place and
//   fed to P·V (a relative error of 2^-9 per weight; the sum l is f32).
// - Q, K and V are staged as bf16 in shared memory with 16-byte cp.async
//   copies (zero-filled past Skv or Sq; the copy loops walk their tiles
//   without a division per copy). K and V are double-buffered: block j+1's
//   copies are in flight while block j's products run, with one barrier a
//   kv block. Head widths pad up to DQ * 16 columns (Q and K) and DV * 16
//   (V and O) with zeros written once into shared memory; the row stride
//   D * 16 + 8 puts the 8 rows of an ldmatrix on distinct banks. Up to Dh
//   = Dv = 128 both pad to one width, DQ = DV; MLA's Dh 192 and Dv 128
//   (DeepSeek-V3's qk_nope 128 + qk_rope 64, v 128) run at DQ = 12 and DV
//   = 8, so the output takes 64 accumulator registers a thread, not 96.
//   Head widths of no whole 16-byte vector (Dh = 30) stage through a
//   scalar loop into the same tiles.
// - Occupancy: 128 registers a thread at DQ = DV <= 5 and 67.5 KB of shared
//   memory at Dh 80 give 2 blocks, 16 warps, an SM, so the serving shape's
//   256 blocks run in one wave of 264 slots, and each (batch, head) reads
//   its K and V once. Measured against the alternatives on the card
//   (PERF.md §6): 4 warps and 64 rows a block (4 blocks an SM), two
//   m-tiles a warp, a 3-stage ring, and two barriers a kv block were all
//   slower.
// - wgmma with TMA and warp-specialised producers would pay at long
//   sequences (whisper's 1500-frame encoder, 8k-token prefills), where this
//   design is 1.6x SDPA; at the serving shape the time is set by bytes,
//   latency and occupancy.
// - At DQ = 12, DV = 8 a block takes 134 KB of shared memory (Q 50 KB, two
//   K and V stages 84 KB), so one block of 8 warps runs an SM; deepseek's
//   prefill (8 x 64 queries, 128 heads) is 1024 blocks, 7.8 waves of 132.
//
// float32, `fa_f32_kernel`: products on the CUDA cores in f32 (tensor
// cores would round f32 to TF32, and no serving path attends in f32).
// One block of 128 threads per (64 query rows, head, batch); each thread
// owns 8 query rows, ty + 8r (ty = tid / 16), and of each 64-key block the
// 4 score columns tx + 16c (tx = tid % 16), so a row's max and sum are
// shuffles within a half-warp. K and V tiles are staged as f32 in shared
// memory, P goes through shared memory in K's place, and the score and
// P·V loops read shared memory 16 bytes at a time.
//
// Card times at the serving shape (NVIDIA H100 80GB HBM3, 700 W, CUDA
// events): the three earlier designs, all on the CUDA cores, took 142.16,
// 65.57 and 57.44 us (one call a timing window); timed back to back
// (scripts/port_kernel_bench.py), the last of them takes 55.7-57.1 us and
// this tensor-core design 11.4-11.5 us, SDPA 11.9-12.0 us.
#include <cuda_bf16.h>

#include "kernel_error.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv block
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, Dh, Dv, q_offset, causal, vec;
  float scale;
  float* lse;  // (B, H, Sq) f32 log-sum-exp of the scaled scores, or null
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

// DQ, DV: the Q/K and the V/O head widths in 16-column steps (Dh pads up to
// DQ * 16 columns, Dv to DV * 16).
__host__ __device__ constexpr int tc_stride(int d16) { return d16 * 16 + 8; }
__host__ __device__ constexpr int tc_tile(int d16) {
  return kBK * tc_stride(d16);
}
constexpr int kStages = 2;  // K, V buffers: block j, and block j+1 in flight
constexpr int kTcWarps = 8;  // 16 query rows each
constexpr int kTcBQ = 16 * kTcWarps;  // query rows per block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kQTiles = kTcBQ / kBK;  // Q's rows, in tiles of kBK rows
// The K, V ring (stage s: K at s (tc_tile(DQ) + tc_tile(DV)), V after it),
// then Q (kQTiles tiles of width DQ).
__host__ __device__ constexpr int tc_stage(int dq, int dv) {
  return tc_tile(dq) + tc_tile(dv);
}
__host__ __device__ constexpr int tc_smem_bytes(int dq, int dv) {
  return (kStages * tc_stage(dq, dv) + kQTiles * tc_tile(dq)) *
         static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reduce 8 values as a tree (depth 3, not a chain of 7).
template <typename F>
__device__ __forceinline__ float tree8(const float (&v)[8], F op) {
  return op(op(op(v[0], v[1]), op(v[2], v[3])),
            op(op(v[4], v[5]), op(v[6], v[7])));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}


// A thread's walk over the units of a tile (16-byte vectors, or elements
// where rows are no whole number of vectors): its first (row, unit) and
// its step, so the copy loops divide once per kernel, not once per unit.
struct Walk {
  int r, c, dr, dc, per;
};
__device__ __forceinline__ Walk make_walk(int D, bool vec) {
  const int per = vec ? D / 8 : D;
  return {static_cast<int>(threadIdx.x) / per,
          static_cast<int>(threadIdx.x) % per, kTcThreads / per,
          kTcThreads % per, per};
}

// Stage `rows` rows of a (row stride rs) slab into a tile of row stride
// ts, rows at or past `valid` as zeros: 16-byte asynchronous copies where
// the rows are whole 16-byte vectors and 16-byte aligned (vec), else a
// scalar loop.
__device__ __forceinline__ void stage(bf16* tile, int ts, const bf16* src,
                                      size_t rs, int rows, int valid,
                                      const Walk& w, bool vec) {
  const int unit = vec ? 8 : 1;
  for (int r = w.r, c = w.c; r < rows;) {
    const bool ok = r < valid;
    if (vec)
      cp_async16(smem_addr(tile + r * ts + c * unit),
                 ok ? src + r * rs + c * unit : src, ok);
    else
      tile[r * ts + c] = ok ? src[r * rs + c] : __float2bfloat16(0.f);
    r += w.dr;
    c += w.dc;
    if (c >= w.per) {
      c -= w.per;
      ++r;
    }
  }
}

template <int DQ, int DV, int MIN_BLOCKS>
__global__ void __launch_bounds__(kTcThreads, MIN_BLOCKS)
fa_bf16_kernel(Args a) {
  constexpr int TS = tc_stride(DQ), TV = tc_stride(DV);  // row strides
  constexpr int TE = tc_tile(DQ), SE = tc_stage(DQ, DV);
  constexpr int NT = 2 * DV;  // output tiles of 8 columns
  extern __shared__ uint4 smem_tc[];
  bf16* const base = reinterpret_cast<bf16*>(smem_tc);
  bf16* const Qs = base + kStages * SE;

  // The blocks with the most kv blocks (causal) start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = a.vec != 0;
  const size_t q_rs = size_t(a.H) * a.Dh;
  const size_t k_rs = size_t(a.KV) * a.Dh, v_rs = size_t(a.KV) * a.Dv;
  const bf16* qg = static_cast<const bf16*>(a.q) +
                   (size_t(b) * a.Sq + q0) * q_rs + size_t(h) * a.Dh;
  const bf16* kg = static_cast<const bf16*>(a.k) +
                   size_t(b) * a.Skv * k_rs + size_t(kvh) * a.Dh;
  const bf16* vg = static_cast<const bf16*>(a.v) +
                   size_t(b) * a.Skv * v_rs + size_t(kvh) * a.Dv;

  // Zero columns [D, width) of every tile, once; no copy writes them.
  for (int tile = 0; tile < 2 * kStages + kQTiles; ++tile) {
    const bool v_tile = tile < 2 * kStages && (tile & 1);
    const int D = v_tile ? a.Dv : a.Dh, pad = (v_tile ? DV : DQ) * 16 - D;
    const int ts = v_tile ? TV : TS;
    bf16* tp = tile < 2 * kStages
                   ? base + (tile >> 1) * SE + (v_tile ? TE : 0)
                   : Qs + (tile - 2 * kStages) * TE;
    for (int idx = threadIdx.x; idx < kBK * pad; idx += kTcThreads) {
      const int r = idx / pad;
      tp[r * ts + D + idx - r * pad] = __float2bfloat16(0.f);
    }
  }

  // Causal block skip: keys past the block's last query position.
  const int kv_end =
      a.causal ? min(a.Skv, a.q_offset + q0 + kTcBQ) : a.Skv;
  const int nblk = (kv_end + kBK - 1) / kBK;

  // Copies of kv block j: K, then V, as two groups (empty past the last).
  const Walk wk = make_walk(a.Dh, vec), wv = make_walk(a.Dv, vec);
  auto load_kv = [&](int j) {
    bf16* const Kn = base + (j % kStages) * SE;
    const int k0 = j * kBK;
    if (j < nblk)
      stage(Kn, TS, kg + k0 * k_rs, k_rs, kBK, a.Skv - k0, wk, vec);
    cp_async_commit();
    if (j < nblk)
      stage(Kn + TE, TV, vg + k0 * v_rs, v_rs, kBK, a.Skv - k0, wv, vec);
    cp_async_commit();
  };
  stage(Qs, TS, qg, q_rs, kTcBQ, a.Sq - q0, wk, vec);
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);  // Q joins K0's group
  cp_async_wait<2 * kStages - 3>();                 // Q and K0
  __syncthreads();

  unsigned qf[DQ][4];
  {
    const int r = warp * 16 + (lane & 15), c = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < DQ; ++kk)
      ldsm_x4(smem_addr(Qs + r * TS + c + kk * 16), qf[kk]);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Running max (raw scores) and this lane's part of the row sums.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;  // exp(x * scale) = 2^(x * sl2)
  const int row_lo = a.q_offset + q0 + warp * 16;  // the warp's first row
  // Per-lane ldmatrix offsets within a tile: K rows are keys (B of Q·K^T),
  // V rows are keys read transposed (B of P·V).
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * TS +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * TV +
                    (lane >> 4) * 8;

  for (int j = 0; j < nblk; ++j) {
    const int k0 = j * kBK;
    bf16* const Kt = base + (j % kStages) * SE;
    bf16* const Vt = Kt + TE;
    // Pending: K_j, V_j, then blocks j+1 .. j+kStages-2 (two groups each).
    cp_async_wait<2 * kStages - 4>();  // K_j and V_j
    __syncthreads();  // ... seen by all; block j-1's buffers consumed
    load_kv(j + kStages - 1);

    // Mask only where the block crosses the warp's diagonal or Skv; there
    // the tiles of 8 keys past the warp's last live key are skipped.
    const bool edge = k0 + kBK > a.Skv ||
                      (a.causal && k0 + kBK - 1 > row_lo);
    int n_live = 8;
    if (edge) {
      const int last = min(a.Skv - 1, a.causal ? row_lo + 15 : a.Skv) - k0;
      n_live = last < 0 ? 0 : min(8, last / 8 + 1);
    }

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQ; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (2 * np >= n_live) continue;
        unsigned bk[4];
        ldsm_x4(smem_addr(Kt + np * 16 * TS + kk * 16 + k_off), bk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    if (n_live > 0) {
      if (edge) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + 2 * t + (e & 1);
            if (key >= a.Skv ||
                (a.causal && key > row_lo + g + (e >> 1) * 8))
              s[n][e] = kNegInf;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t8[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          t8[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
        float mx = tree8(t8, [](float x, float y) { return fmaxf(x, y); });
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        // Key 0 is live for every row, so m is a score after block 0.
        const float m_new = fmaxf(m[r], mx);
        const float corr = exp2_approx((m[r] - m_new) * sl2);
        const float msl = m_new * sl2;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const bool live = n < n_live;
          const float p0 =
              live ? exp2_approx(fmaf(s[n][2 * r], sl2, -msl)) : 0.f;
          const float p1 =
              live ? exp2_approx(fmaf(s[n][2 * r + 1], sl2, -msl)) : 0.f;
          s[n][2 * r] = p0;
          s[n][2 * r + 1] = p1;
          t8[n] = p0 + p1;
        }
        l[r] = l[r] * corr + tree8(t8, [](float x, float y) { return x + y; });
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk >= n_live) continue;
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DV; ++np) {
        unsigned bv[4];
        ldsm_x4_trans(smem_addr(Vt + kk * 16 * TV + np * 16 + v_off), bv);
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* const og = static_cast<bf16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(kFull, l[r], 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.Sq) continue;
    // m is the raw score max: the row's sum was of exp(scale * (s - m)).
    if (a.lse != nullptr && t == 0)
      a.lse[(size_t(b) * a.H + h) * a.Sq + row] =
          fmaf(m[r], a.scale, logf(fmaxf(lt, 1e-30f)));
    bf16* orow = og + ((size_t(b) * a.Sq + row) * a.H + h) * a.Dv;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + 2 * t;
      const float v0 = o[n][2 * r] * inv, v1 = o[n][2 * r + 1] * inv;
      if (vec) {
        if (c < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < a.Dv) orow[c] = __float2bfloat16(v0);
        if (c + 1 < a.Dv) orow[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// Registers: Q fragments 4 DQ, the output 8 DV, scores 32 a thread; up to
// DQ = DV = 5 they fit 128, so 16 warps share an SM (8 at 8, and at DQ =
// 12, DV = 8: 144 in the three arrays, under the 255 of one block an SM).
constexpr int tc_min_blocks(int dq, int dv) {
  return (dq <= 5 && dv <= 5 ? 16 : 8) / kTcWarps;
}

template <int DQ, int DV>
int tc_set_attributes() {
  const auto kern = fa_bf16_kernel<DQ, DV, tc_min_blocks(DQ, DV)>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes(DQ, DV));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int DQ, int DV>
int tc_launch(const Args& a, cudaStream_t stream) {
  static const int attr = tc_set_attributes<DQ, DV>();
  if (attr) return attr;
  const dim3 grid((a.Sq + kTcBQ - 1) / kTcBQ, a.H, a.B);
  fa_bf16_kernel<DQ, DV, tc_min_blocks(DQ, DV)>
      <<<grid, kTcThreads, tc_smem_bytes(DQ, DV), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV>
int tc_blocks_per_sm() {
  if (const int attr = tc_set_attributes<DQ, DV>()) return -attr;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, fa_bf16_kernel<DQ, DV, tc_min_blocks(DQ, DV)>, kTcThreads,
      tc_smem_bytes(DQ, DV));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The instantiated widths, Q/K and V/O alike: 32, 64, 80 and 128 columns;
// and Q/K 192 with V/O 128 (MLA). Returns the case, 0 for none.
int tc_width(int Dh, int Dv) {
  const int dq = (Dh + 15) / 16, dv = (Dv + 15) / 16;
  if (dq > 8) return dq <= 12 && dv <= 8 ? 12 : 0;
  const int d16 = dq > dv ? dq : dv;
  return d16 <= 2 ? 2 : d16 <= 4 ? 4 : d16 <= 5 ? 5 : d16 <= 8 ? 8 : 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kRows = 8;       // query rows per thread: kBQ / (kThreads / 16)
constexpr int kCols = 4;       // score columns per thread: kBK / 16
constexpr int kPs = kBK + 4;   // P row stride

// Max / sum over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float half_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int qk_stride(int dh) { return round4(dh) + 4; }
// K and P share one region: K is dead once the scores are in registers.
__host__ __device__ constexpr int kp_floats(int dh) {
  return kBK * qk_stride(dh) > kBQ * kPs ? kBK * qk_stride(dh) : kBQ * kPs;
}
__host__ __device__ constexpr int smem_floats(int dh, int ncv) {
  return kBQ * qk_stride(dh) + kp_floats(dh) + kBK * ncv * 16;
}

// Stage rows x D of a (rows, row stride rs) slab into shared memory (row
// stride ds), zero past `valid` rows and in columns [D, Dpad). `vec`: D is
// a whole number of 16-byte vectors and the slab is 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* src,
                                          size_t rs, int rows, int valid,
                                          int D, int Dpad, bool vec) {
  if (vec) {
    const int vpr = D / 4;
    for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
      const int r = idx / vpr, c = (idx - r * vpr) * 4;
      *reinterpret_cast<float4*>(dst + r * ds + c) =
          r < valid ? *reinterpret_cast<const float4*>(src + r * rs + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      dst[r * ds + c] = r < valid ? src[r * rs + c] : 0.f;
    }
  }
  const int pad = Dpad - D;
  for (int idx = threadIdx.x; idx < rows * pad; idx += kThreads) {
    const int r = idx / pad;
    dst[r * ds + D + (idx - r * pad)] = 0.f;
  }
}

// NCV: output columns per thread, ceil(Dv / 16) rounded up to an
// instantiated width; the V tile's row stride is NCV * 16.
template <int NCV>
__global__ void __launch_bounds__(kThreads) fa_f32_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qs = qk_stride(a.Dh), dh4 = round4(a.Dh);
  constexpr int vs = NCV * 16;
  float* Qs = smem;                    // kBQ x qs
  float* Ks = Qs + kBQ * qs;           // kBK x qs, then P: kBQ x kPs
  float* Ps = Ks;
  float* Vs = Ks + kp_floats(a.Dh);    // kBK x vs

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const bool vec = a.vec != 0;
  const size_t q_rs = size_t(a.H) * a.Dh;
  const size_t k_rs = size_t(a.KV) * a.Dh, v_rs = size_t(a.KV) * a.Dv;
  const float* qb = static_cast<const float*>(a.q) +
                    (size_t(b) * a.Sq + q0) * q_rs + size_t(h) * a.Dh;
  const float* kb = static_cast<const float*>(a.k) +
                    size_t(b) * a.Skv * k_rs + size_t(kvh) * a.Dh;
  const float* vb = static_cast<const float*>(a.v) +
                    size_t(b) * a.Skv * v_rs + size_t(kvh) * a.Dv;
  float* o = static_cast<float*>(a.o);

  load_tile(Qs, qs, qb, q_rs, kBQ, a.Sq - q0, a.Dh, dh4, vec);

  float m[kRows], l[kRows], acc[kRows][NCV];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NCV; ++j) acc[r][j] = 0.f;
  }

  // Causal block skip: keys past the block's last query position.
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(kv_end, a.q_offset + q0 + kBQ);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // Q is staged; the last block's K, V, P are consumed
    load_tile(Ks, qs, kb + k0 * k_rs, k_rs, kBK, a.Skv - k0, a.Dh, dh4, vec);
    load_tile(Vs, vs, vb + k0 * v_rs, v_rs, kBK, a.Skv - k0, a.Dv, vs, vec);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    for (int d = 0; d < dh4; d += 4) {
      float4 kc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        kc[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * qs + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty + 8 * r) * qs + d]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          s[r][c] = fmaf(qv.w, kc[c].w,
                         fmaf(qv.z, kc[c].z,
                              fmaf(qv.y, kc[c].y,
                                   fmaf(qv.x, kc[c].x, s[r][c]))));
      }
    }

    __syncthreads();  // every score is in registers: K's region takes P

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = a.q_offset + q0 + ty + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const bool dead = kpos >= a.Skv || (a.causal && kpos > qpos);
        s[r][c] = dead ? kNegInf : s[r][c] * a.scale;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], half_max(mx));
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty + 8 * r) * kPs + tx + 16 * c] = p;
        rs += p;
      }
      l[r] = l[r] * corr + half_sum(rs);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NCV; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    // V rows past Skv are zero: stop at the last live key, rounded up to 4.
    const int kn = round4(min(kBK, a.Skv - k0));
    for (int jj = 0; jj < kn; jj += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(&Ps[(ty + 8 * r) * kPs + jj]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[NCV];
#pragma unroll
        for (int j = 0; j < NCV; ++j) vv[j] = Vs[(jj + t) * vs + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = t == 0 ? pv[r].x
                        : t == 1 ? pv[r].y
                        : t == 2 ? pv[r].z : pv[r].w;
#pragma unroll
          for (int j = 0; j < NCV; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = q0 + ty + 8 * r;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && tx == 0)
      a.lse[(size_t(b) * a.H + h) * a.Sq + s] = m[r] + logf(den);
    float* orow = o + ((size_t(b) * a.Sq + s) * a.H + h) * a.Dv;
#pragma unroll
    for (int j = 0; j < NCV; ++j) {
      const int d = tx + 16 * j;
      if (d < a.Dv) orow[d] = acc[r][j] / den;
    }
  }
}

template <int NCV>
int f32_launch(const Args& a, cudaStream_t stream) {
  const int bytes = smem_floats(a.Dh, NCV) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  fa_f32_kernel<NCV><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int f32_launch_width(const Args& a, cudaStream_t stream) {
  const int ncv = (a.Dv + 15) / 16;
  if (ncv <= 2) return f32_launch<2>(a, stream);
  if (ncv <= 4) return f32_launch<4>(a, stream);
  if (ncv <= 5) return f32_launch<5>(a, stream);
  if (ncv <= 8) return f32_launch<8>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int bf16_launch_width(const Args& a, cudaStream_t stream) {
  switch (tc_width(a.Dh, a.Dv)) {
    case 2: return tc_launch<2, 2>(a, stream);
    case 4: return tc_launch<4, 4>(a, stream);
    case 5: return tc_launch<5, 5>(a, stream);
    case 8: return tc_launch<8, 8>(a, stream);
    case 12: return tc_launch<12, 8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). Dh <= 192 and
// Dv <= 128 (Dh, Dv <= 128, or Dh in 129..192 with Dv <= 128);
// the wrapper checks shapes, types and contiguity. vec: Dh and Dv are
// whole 16-byte vectors and q, k, v are 16-byte aligned. lse: null, or a
// (B, H, Sq) f32 buffer that takes each query row's log-sum-exp of its
// scaled scores (the backward's softmax statistic); the output is the same
// either way. It comes last, so that one call serves libraries built with
// and without it (scripts/port_kernel_bench.py passes null to both).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int Dh, int Dv,
                                      int q_offset, int causal, int vec,
                                      float scale, int dtype, void* stream,
                                      float* lse) {
  const Args a{q, k, v, o, B, Sq, Skv, H, KV, Dh, Dv, q_offset, causal, vec,
               scale, lse};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32_launch_width(a, s);
  if (dtype == 1) return bf16_launch_width(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the bfloat16 kernel that fit one SM at head widths Dh, Dv
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative value is a
// cudaError_t.
extern "C" int flash_attention_bf16_blocks_per_sm(int Dh, int Dv) {
  switch (tc_width(Dh, Dv)) {
    case 2: return tc_blocks_per_sm<2, 2>();
    case 4: return tc_blocks_per_sm<4, 4>();
    case 5: return tc_blocks_per_sm<5, 5>();
    case 8: return tc_blocks_per_sm<8, 8>();
    case 12: return tc_blocks_per_sm<12, 8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
