// Flash attention forward (FA2-style online softmax), for Hopper.
//
// Replaces the Pallas TPU kernel `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py:28). In the model's layout,
// q (B, Sq, H, Dh), k (B, Skv, KV, Dh), v (B, Skv, KV, Dv) -> o (B, Sq, H,
// Dv), with H % KV == 0 (query head h reads kv head h / (H / KV)), scores
// scaled by 1/sqrt(Dh), and causal masking of key position j > q_offset + i
// for query row i. Running max, denominator and accumulator are f32.
//
// Bound: at stablelm-3b's prefill (S = 120, Dh = 80) the work is small and
// the bytes (q, k, v and o once each) bound it; this first kernel runs its
// products on the CUDA cores in f32, not on the tensor cores (mma.sync,
// wgmma and TMA are later work), so it sits far above that bound.
//
// Design: one block of 128 threads per (q block of 64 rows, head, batch).
// The TPU kernel's sequential kv grid axis, which carried (m, l, acc) in
// VMEM scratch, becomes a loop inside the block that carries them in
// registers. Each thread owns 8 query rows, ty + 8r (ty = tid / 16), and
// of each 64-key block the 4 score columns tx + 16c (tx = tid % 16), so a
// row's max and sum are shuffles within a half-warp; for the accumulator
// it owns the same 8 rows and the output columns tx + 16j, j < NCV. Per kv
// block: K and V tiles are staged in shared memory as f32 (16-byte loads
// from device memory where the head width allows), scores and the online
// softmax run in registers, P goes through shared memory (in K's place,
// which leaves room for 3 blocks on an SM at Dh = 80), and acc += P V.
// The score and P·V loops read shared memory 16 bytes at a time (4 head
// dims of a q or k row, 4 keys of a P row), so each load feeds 4 FMAs.
// Blocks wholly above the causal diagonal are never loaded (block skip);
// keys past Skv and queries past Sq are masked, so there is no padding
// copy, and head widths that are no power of two (Dh = 80) are handled by
// loop bounds and zero columns in shared memory up to a multiple of 4, not
// by padding q/k/v. Row strides (Dh rounded up to 4, plus 4; 68 for P)
// keep the 16-byte reads of 8 neighbouring rows on distinct banks.
#include <cuda_bf16.h>

#include "kernel_error.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv block
constexpr int kThreads = 128;
constexpr int kRows = 8;       // query rows per thread: kBQ / (kThreads / 16)
constexpr int kCols = 4;       // score columns per thread: kBK / 16
constexpr int kPs = kBK + 4;   // P row stride
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, Dh, Dv, q_offset, causal, vec;
  float scale;
};

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
  return __float2bfloat16(x);
}

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

// Stage rows x D of a (rows, row stride rs) slab as f32 into shared memory
// (row stride ds), zero past `valid` rows and in columns [D, Dpad). `vec`:
// D is a whole number of 16-byte vectors and the slab is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          size_t rs, int rows, int valid,
                                          int D, int Dpad, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int vpr = D / V;
    for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
      const int r = idx / vpr, c = (idx - r * vpr) * V;
      float f[V];
      if (r < valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * rs + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = 0.f;
      }
      float4* out = reinterpret_cast<float4*>(dst + r * ds + c);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        out[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                             f[4 * i + 3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D, c = idx - r * D;
      dst[r * ds + c] = r < valid ? to_f32(src[r * rs + c]) : 0.f;
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
template <typename T, int NCV>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(Args a) {
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
  const T* qb = static_cast<const T*>(a.q) + (size_t(b) * a.Sq + q0) * q_rs +
                size_t(h) * a.Dh;
  const T* kb = static_cast<const T*>(a.k) + size_t(b) * a.Skv * k_rs +
                size_t(kvh) * a.Dh;
  const T* vb = static_cast<const T*>(a.v) + size_t(b) * a.Skv * v_rs +
                size_t(kvh) * a.Dv;
  T* o = static_cast<T*>(a.o);

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
    T* orow = o + ((size_t(b) * a.Sq + s) * a.H + h) * a.Dv;
#pragma unroll
    for (int j = 0; j < NCV; ++j) {
      const int d = tx + 16 * j;
      if (d < a.Dv) orow[d] = from_f32<T>(acc[r][j] / den);
    }
  }
}

template <typename T, int NCV>
int launch(const Args& a, cudaStream_t stream) {
  const int bytes = smem_floats(a.Dh, NCV) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  fa_fwd_kernel<T, NCV><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(const Args& a, cudaStream_t stream) {
  const int ncv = (a.Dv + 15) / 16;
  if (ncv <= 2) return launch<T, 2>(a, stream);
  if (ncv <= 4) return launch<T, 4>(a, stream);
  if (ncv <= 5) return launch<T, 5>(a, stream);
  if (ncv <= 8) return launch<T, 8>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). Dh, Dv <= 128;
// the wrapper checks shapes, types and contiguity. vec: Dh and Dv are
// whole 16-byte vectors and q, k, v are 16-byte aligned.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int Dh, int Dv,
                                      int q_offset, int causal, int vec,
                                      float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, B, Sq, Skv, H, KV, Dh, Dv, q_offset, causal, vec,
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_width<float>(a, s);
  if (dtype == 1) return launch_width<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
