// Forward attention with positional masks (the port of the JAX package's
// Pallas kernel repro/kernels/flash_attention.py::_flash_kernel).
//
// For query row r of head h and key c of its kv head h / G:
//   s = (q_r . k_c) / sqrt(D), or -1e30 where the key is dead (kpos < 0),
//   in the future (causal, kpos > qpos) or out of the window
//   (kpos <= qpos - window);
//   out_r = softmax(s) V, in q's dtype.
// The masked score is the finite -1e30, as in the JAX kernel: a row with no
// live key gets the uniform mean of V over the Sk keys, never NaN.
//
// One block of 256 threads per (batch x query head, 64-row q block), on the
// CUDA cores in f32.  K/V tiles of 32 keys stream through shared memory
// (converted to f32 as they are staged) and the running (max, sum, acc) of
// the online softmax stays in f32 registers.  Per tile: S = Q K^T (each
// thread 4 rows x 2 keys), the softmax update (4 threads per row), then
// acc = acc * corr + P V (each thread 4 rows x NC column groups of 16).
// A tile in which no (query, key) pair of the block can be live is skipped;
// rows that never meet a live key take the mean of V instead, so skipping
// never changes a result.  The kv head is read at h / G and the layout comes
// in as strides, so neither K/V per query head nor a head-major copy exists.
// Heavy q blocks (late rows under a causal mask) launch first.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

struct Strides {
  long long b, h, s;  // batch, head and sequence strides in elements; features are contiguous
};

struct Geometry {
  int H, G, Sq, Sk, D;
  Strides q, k, v, o;
  int causal, use_window, window;
  float scale;
};

template <int NC>
struct Smem {
  static constexpr int kDP = 16 * NC;  // V row stride: D rounded up to the column groups
  static size_t bytes(int D) {
    const int dq = repro::smem_stride(D);
    return sizeof(float) * ((size_t)kBQ * dq + (size_t)kBK * dq + (size_t)kBK * kDP +
                            (size_t)kBQ * (kBK + 1) + 4 * kBQ + kBK + kDP);
  }
};

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ qpos, const int* __restrict__ kpos, T* __restrict__ out,
             Geometry g) {
  constexpr int kDP = Smem<NC>::kDP;
  extern __shared__ float smem[];
  const int D = g.D, dq = repro::smem_stride(D);
  float* Qs = smem;                    // kBQ x dq
  float* Ks = Qs + kBQ * dq;           // kBK x dq
  float* Vs = Ks + kBK * dq;           // kBK x kDP
  float* Ss = Vs + kBK * kDP;          // kBQ x (kBK + 1) scores, then P
  float* corr_s = Ss + kBQ * (kBK + 1);
  float* l_s = corr_s + kBQ;
  int* live_s = reinterpret_cast<int*>(l_s + kBQ);
  int* qpos_s = live_s + kBQ;
  int* kpos_s = qpos_s + kBQ;
  float* vmean = reinterpret_cast<float*>(kpos_s + kBK);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heavy (late) blocks first
  const int q0 = qb * kBQ;
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H, kvh = h / g.G;
  const T* qh = q + b * g.q.b + h * g.q.h;
  const T* kh = k + b * g.k.b + kvh * g.k.h;
  const T* vh = v + b * g.v.b + kvh * g.v.h;
  T* oh = out + b * g.o.b + h * g.o.h;
  const int* qp = qpos + (size_t)b * g.Sq;
  const int* kp = kpos + (size_t)b * g.Sk;

  for (int t = tid; t < kBQ * D; t += kThreads) {
    const int r = t / D, c = t - r * D;
    Qs[r * dq + c] = q0 + r < g.Sq ? to_f32(qh[(q0 + r) * g.q.s + c]) : 0.f;
  }
  for (int t = tid; t < kBK * kDP; t += kThreads) Vs[t] = 0.f;  // pad columns stay 0
  if (tid < kBQ) {
    qpos_s[tid] = q0 + tid < g.Sq ? qp[q0 + tid] : 0;
    live_s[tid] = 0;
  }
  __syncthreads();
  // the block's query position range (real rows only), for the tile skip
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < min(kBQ, g.Sq - q0); ++r) {
    qmin = min(qmin, qpos_s[r]);
    qmax = max(qmax, qpos_s[r]);
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  float m_run = kMasked, l_run = 0.f;  // softmax state of row tid >> 2 (4 threads per row)

  for (int k0 = 0; k0 < g.Sk; k0 += kBK) {
    int maybe_live = 0;
    if (tid < kBK) {
      const int kpv = k0 + tid < g.Sk ? kp[k0 + tid] : -1;
      kpos_s[tid] = kpv;
      maybe_live = kpv >= 0 && (!g.causal || kpv <= qmax) &&
                   (!g.use_window || (long long)kpv > (long long)qmin - g.window);
    }
    if (!__syncthreads_or(maybe_live)) continue;  // every pair of the tile is masked

    for (int t = tid; t < kBK * D; t += kThreads) {
      const int r = t / D, c = t - r * D;
      const bool in = k0 + r < g.Sk;
      Ks[r * dq + c] = in ? to_f32(kh[(k0 + r) * g.k.s + c]) : 0.f;
      Vs[r * kDP + c] = in ? to_f32(vh[(k0 + r) * g.v.s + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T * scale, masked: rows ty + 16i, keys tx + 16j
    {
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        const float k0v = Ks[tx * dq + kk], k1v = Ks[(tx + 16) * dq + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qv = Qs[(ty + 16 * i) * dq + kk];
          s[i][0] = __fmaf_rn(qv, k0v, s[i][0]);
          s[i][1] = __fmaf_rn(qv, k1v, s[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qv = qpos_s[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const int kv = kpos_s[c];
          const bool masked = kv < 0 || (g.causal && kv > qv) ||
                              (g.use_window && (long long)kv <= (long long)qv - g.window);
          if (!masked) live_s[r] = 1;
          Ss[r * (kBK + 1) + c] = masked ? kMasked : __fmul_rn(s[i][j], g.scale);
        }
      }
    }
    __syncthreads();

    // online softmax: row tid >> 2, keys 8 * (tid & 3) .. + 7
    {
      const int r = tid >> 2, c0 = 8 * (tid & 3);
      float* srow = Ss + r * (kBK + 1) + c0;
      float tmax = kMasked;
#pragma unroll
      for (int c = 0; c < 8; ++c) tmax = fmaxf(tmax, srow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run, tmax);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + psum;
      m_run = m_new;
      if ((tid & 3) == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= cr;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[kk * kDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = __fmaf_rn(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();  // Ks, Vs, Ss and corr_s are refilled by the next tile
  }

  if ((tid & 3) == 0) l_s[tid >> 2] = l_run;
  const bool dead_row = tid < kBQ && q0 + tid < g.Sq && !live_s[tid];
  if (__syncthreads_or(dead_row)) {
    // rows without a live key: the uniform mean of V over every key
    for (int c = tid; c < D; c += kThreads) {
      float sum = 0.f;
      for (int key = 0; key < g.Sk; ++key) sum += to_f32(vh[key * g.v.s + c]);
      vmean[c] = sum / static_cast<float>(g.Sk);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= g.Sq) continue;
    const bool live = live_s[r] != 0;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = oh + (q0 + r) * g.o.s;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < D) orow[c] = from_f32<T>(live ? __fdiv_rn(acc[i][j], l) : vmean[c]);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out,
           int B, const Geometry& g, cudaStream_t stream) {
  const size_t smem = Smem<NC>::bytes(g.D);
  auto kernel = flash_kernel<T, NC>;
  const cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.Sq + kBQ - 1) / kBQ, B * g.H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), qpos, kpos,
                                           static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
             void* out, int B, const Geometry& g, cudaStream_t stream) {
  const int groups = (g.D + 15) / 16;
  if (groups <= 1) return launch<T, 1>(q, k, v, qpos, kpos, out, B, g, stream);
  if (groups <= 2) return launch<T, 2>(q, k, v, qpos, kpos, out, B, g, stream);
  if (groups <= 4) return launch<T, 4>(q, k, v, qpos, kpos, out, B, g, stream);
  if (groups <= 8) return launch<T, 8>(q, k, v, qpos, kpos, out, B, g, stream);
  return launch<T, 16>(q, k, v, qpos, kpos, out, B, g, stream);
}

}  // namespace

// q (B, H, Sq, D), k and v (B, KV, Sk, D), out (B, H, Sq, D) as strided
// views (element strides for batch, head and sequence; features
// contiguous), all f32 (dtype 0) or all bf16 (dtype 1); qpos (B, Sq) and
// kpos (B, Sk) contiguous int32.  H = KV * G, 1 <= D <= 256, Sk >= 1.
// window is used when use_window.  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     const void* qpos, const void* kpos, void* out, int B, int H,
                                     int KV, int Sq, int Sk, int D, long long qsb, long long qsh,
                                     long long qss, long long ksb, long long ksh, long long kss,
                                     long long vsb, long long vsh, long long vss, long long osb,
                                     long long osh, long long oss, int causal, int use_window,
                                     int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 ||
      (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{H, H / KV, Sq, Sk, D, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
             {osb, osh, oss}, causal, use_window, window, scale};
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, qp, kp, out, B, g, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, qp, kp, out, B, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
