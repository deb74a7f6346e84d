// Forward attention with positional masks on the CUDA cores in f32 (the
// port of the JAX package's Pallas kernel
// repro/kernels/flash_attention.py::_flash_kernel), redesigned for Hopper
// from the earlier kernel in flash_attention.cu, which stays as its oracle.
// It serves every f32 call and the bf16 calls the tensor-core kernel
// (flash_attention_mma.cu) refuses: D in (128, 256], and views its 16-byte
// copies cannot read.
//
// For query row r of head h and key c of its kv head h / G:
//   s = (q_r . k_c) / sqrt(D), or -1e30 where the key is dead (kpos < 0),
//   in the future (causal, kpos > qpos) or out of the window
//   (kpos <= qpos - window);
//   out_r = softmax(s) V, in q's dtype.
// The masked score is the finite -1e30, as in the JAX kernel: a row with no
// live key gets the uniform mean of V over the Sk keys, never NaN.  Where the
// caller passes lse (training), the kernel also writes the row's
// log-sum-exp of the scaled scores in f32 from the (m, l) it keeps anyway,
// +inf on a row with no live key (the backward's mark for such a row).
//
// Bound on the H100: operations.  QK^T and PV take 4 D FLOPs per live
// (query, key) pair and head, IEEE f32 FMAs (__fmaf_rn) on the CUDA cores
// (no TF32, no tensor cores): 51.5 GFLOP, 0.77 ms at 67 TFLOP/s, for
// qwen2-1.5b's attention at S = 4096.  The earlier kernel fed its FMAs from
// scalar shared loads (1.8 FMAs per shared wavefront) and ran five block
// barriers per 32-key tile.  Here:
//
//  * Warps of 16 query rows; lane (rg, kg) = (lane / 8, lane % 8) owns rows
//    rg + 4i (i < 4), keys kg + 8j (j < 4) of each 32-key tile, and output
//    columns 32u + 4 kg + {0..3} (u < DP / 32).  A thread's O rows are its
//    S rows, and everything a row needs sits in one warp.
//  * Register tiles.  S = Q K^T: per 4 features a lane reads its 4 Q rows
//    and 4 K rows as ld.shared.v4 (rows padded to DP + 4 floats, so the 4
//    or 8 distinct rows a warp asks for lie in distinct banks: at most 128
//    distinct bytes, one wavefront) and issues 64 FMAs: 8 FMAs per
//    wavefront.  O += P V: per key one v4 of P (the lane's 4 rows) and
//    DP / 32 v4 of V (8 lanes read 128 contiguous bytes) feed 16 DP / 32
//    FMAs: 12.8 FMAs per wavefront at DP = 128 (8 at 32, 10.7 at 64, 14.2
//    at 256).  The earlier kernel: 1.8.  Neither loop has a branch.
//  * Softmax in registers: m, l and the correction factor of a row stay in
//    its 8 lanes; the row max is a __shfl_xor_sync butterfly over them, and
//    l is summed per lane and reduced once at the end.  P goes to a
//    per-warp shared buffer (key-major, for PV's v4 loads) behind a
//    __syncwarp: one block barrier per key tile, where the earlier kernel
//    had five.
//  * A two-stage K/V ring.  A pre-scan of kpos lists the tiles in which
//    some (query, key) pair of the block can be live; the sweep visits only
//    those, and the next listed tile's copies are in flight while this one
//    is computed.  f32 comes by cp.async: 16-byte copies where every row of
//    q, k and v starts 16-byte aligned and D % 4 == 0, 4-byte ones
//    otherwise.  bf16 comes by plain loads, converted to f32 as it is
//    staged (cp.async cannot convert): 16-byte loads where the rows allow
//    (D % 8 == 0), 2-byte ones otherwise.  So no dtype adds an alignment
//    rule.  A warp whose rows see no live key in a tile skips it (exact:
//    such a tile would add p = 0, or weights that a later live key zeroes);
//    rows that never meet a live key take the mean of V instead.
//  * Templates on the head-dim bucket DP in {32, 64, 128, 256} (zero
//    padded; both products run over the whole bucket) and on T in {float,
//    bf16}.  Query rows per block, shared memory and blocks per SM:
//      DP <=  128: 192 rows (12 warps), 71.2 / 111.3 / 191.6 KB at
//                  DP = 32 / 64 / 128, one block per SM: 12 warps at 168
//                  registers fill the register file;
//      DP  =  256:  64 rows (4 warps), 205.5 KB, one block per SM: Q and a
//                  ring of 260-float rows leave no room for more rows.
//    Two blocks of 256 threads at DP = 128 would need 2 x 151 KB of shared
//    memory and spill at 128 registers; 8 warps per SM (two blocks of 4, or
//    one of 8) run qwen2-1.5b's f32 attention about a fifth slower than 12
//    (kernels/flash_variants.py, PERF.md).  Every instantiation has 0 bytes
//    of stack and no spills.
//  * Heavy (late) q blocks of every head launch first.  The kv head is read
//    at h / G and the layout comes in as strides: no K/V copy per query
//    head, no head-major copy.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;      // keys per tile: 8 key lanes x 4 keys
constexpr int kChunk = 512;  // tiles listed per pre-scan (16,384 keys)
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;  // batch, head and sequence strides in elements; features are contiguous
};

struct Geometry {
  int BH, H, G, Sq, Sk, D, n_qblocks;
  Strides q, k, v, o;
  int causal, use_window, window;
  float scale;
  int vec;  // every row of q, k and v starts 16-byte aligned and D fills whole 16 bytes: 16-byte copies
  float* lse;  // (B, H, Sq) contiguous f32, or null
};

// Per head-dim bucket DP: 16 query rows per warp, one block per SM, and
// the shared memory, in floats from the base: Q (kBQ rows), two K and two
// V stages (kBK rows each), P (per warp, kBK keys x 16 rows), the mean of
// V, then the ints: two stages of kpos, the block's qpos, the tile list,
// the reductions.
template <int DP>
struct Layout {
  static constexpr int kWarps = DP <= 128 ? 12 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  static constexpr int kSQ = DP + 4;  // floats per Q or K row: consecutive rows start 4 banks apart
  static constexpr int kSV = DP;      // floats per V row: a load reads within one row
  static constexpr int kK = kBK * kSQ, kV = kBK * kSV, kP = kBK * 16;
  static constexpr int oK = kBQ * kSQ, oV = oK + 2 * kK, oP = oV + 2 * kV, oMean = oP + kWarps * kP;
  static constexpr int oInts = oMean + DP;
  static constexpr size_t kBytes =
      sizeof(float) * oInts + sizeof(int) * (2 * kBK + kBQ + kChunk + 2 * kWarps + 1);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool masked(int kp, int qp, const Geometry& g) {
  return kp < 0 || (g.causal && kp > qp) || (g.use_window && (long long)kp <= (long long)qp - g.window);
}

// Start the copies of kRows rows of a strided f32 (rows, D) view into
// shared rows of `ss` floats, zero past `valid` rows and from D to DP.
// Call with the whole block; the caller commits.
template <int DP, int kRows, int kThreads>
__device__ __forceinline__ void stage(float* dst, int ss, const float* __restrict__ src, long long stride, int valid,
                                      int D, bool vec) {
  if (vec) {
    constexpr int kC = DP / 4, kN = kRows * kC;
#pragma unroll 1  // unrolled, its addresses cost the registers that keep the f32 kernels spill-free
    for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      if (kN % kThreads != 0 && t >= kN) break;
      const int r = t / kC, c = 4 * (t % kC);
      const bool ok = r < valid && c < D;
      repro::cp_async16(dst + r * ss + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    constexpr int kN = kRows * DP;
#pragma unroll 4
    for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      if (kN % kThreads != 0 && t >= kN) break;
      const int r = t / DP, c = t % DP;
      const bool ok = r < valid && c < D;
      repro::cp_async4(dst + r * ss + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// bf16: plain loads (16 bytes where the rows allow, else 2), converted to
// f32 as they are staged.
template <int DP, int kRows, int kThreads>
__device__ __forceinline__ void stage(float* dst, int ss, const bf16* __restrict__ src, long long stride, int valid,
                                      int D, bool vec) {
  if (vec) {
    constexpr int kC = DP / 8, kN = kRows * kC;
#pragma unroll 4
    for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      if (kN % kThreads != 0 && t >= kN) break;
      const int r = t / kC, c = 8 * (t % kC);
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < D) u = *reinterpret_cast<const uint4*>(src + r * stride + c);
      float* d = dst + r * ss + c;
      *reinterpret_cast<float4*>(d) = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                                                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
      *reinterpret_cast<float4*>(d + 4) = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                                                      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
    }
  } else {
    constexpr int kN = kRows * DP;
#pragma unroll 4
    for (int it = 0; it < (kN + kThreads - 1) / kThreads; ++it) {
      const int t = threadIdx.x + it * kThreads;
      if (kN % kThreads != 0 && t >= kN) break;
      const int r = t / DP, c = t % DP;
      dst[r * ss + c] = r < valid && c < D ? __bfloat162float(src[r * stride + c]) : 0.f;
    }
  }
}

// List, in list_s, the tiles [c0, c0 + kChunk) in which some (query, key)
// pair of the block can be live, and return how many.  Call with the whole
// block; ends synchronised.
template <int kWarps>
__device__ __forceinline__ int scan_tiles(const int* __restrict__ kp, int c0, int qmin, int qmax,
                                          const Geometry& g, int* list_s, int* count_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = min(kChunk, (g.Sk + kBK - 1) / kBK - c0);
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int key = (c0 + t) * kBK + lane;
    const int kv = key < g.Sk ? kp[key] : -1;
    const bool any = __any_sync(0xffffffffu, kv >= 0 && (!g.causal || kv <= qmax) &&
                                                 (!g.use_window || (long long)kv > (long long)qmin - g.window));
    if (lane == 0) list_s[t] = any;
  }
  __syncthreads();
  if (warp == 0) {  // compact in place: an entry moves only to a lower or equal slot
    int n = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const bool live = base + lane < n_tiles && list_s[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) list_s[n + __popc(ballot & ((1u << lane) - 1))] = c0 + base + lane;
      n += __popc(ballot);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  return *count_s;
}

template <typename T, int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
flash_panel_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ qpos, const int* __restrict__ kpos, T* __restrict__ out, Geometry g) {
  using L = Layout<DP>;
  constexpr int kWarps = L::kWarps, kThreads = L::kThreads, kBQ = L::kBQ;
  constexpr int kSQ = L::kSQ, kSV = L::kSV, kNC = DP / 32;  // kNC: v4 column groups per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + L::oK;
  float* Vs = smem + L::oV;
  float* vmean = smem + L::oMean;
  int* kpos_s = reinterpret_cast<int*>(smem + L::oInts);  // 2 x kBK
  int* qpos_s = kpos_s + 2 * kBK;                          // kBQ
  int* list_s = qpos_s + kBQ;                              // kChunk
  int* red_s = list_s + kChunk;                            // 2 x kWarps
  int* count_s = red_s + 2 * kWarps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kg = lane & 7, rg = lane >> 3;
  const int bh = blockIdx.x % g.BH;
  const int q0 = (g.n_qblocks - 1 - blockIdx.x / g.BH) * kBQ;  // heavy (late) blocks first
  const int b = bh / g.H, h = bh - b * g.H, kvh = h / g.G;
  const T* kh = k + b * g.k.b + kvh * g.k.h;
  const T* vh = v + b * g.v.b + kvh * g.v.h;
  const int* kp = kpos + (size_t)b * g.Sk;
  const int rows = min(kBQ, g.Sq - q0);
  const bool vec = g.vec != 0;

  stage<DP, kBQ, kThreads>(Qs, kSQ, q + b * g.q.b + h * g.q.h + q0 * g.q.s, g.q.s, rows, g.D, vec);
  repro::cp_async_commit();

  // the block's query positions (0 past Sq), and the position ranges of the
  // warp's and the block's real rows; this thread's rows are
  // warp * 16 + rg + 4i
  const int* qp = qpos + (size_t)b * g.Sq + q0;
  if (tid < kBQ) qpos_s[tid] = tid < rows ? qp[tid] : 0;
  int wqmin = INT_MAX, wqmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + rg + 4 * i;
    if (r < rows) {
      wqmin = min(wqmin, qp[r]);
      wqmax = max(wqmax, qp[r]);
    }
  }
  wqmin = __reduce_min_sync(0xffffffffu, wqmin);
  wqmax = __reduce_max_sync(0xffffffffu, wqmax);
  if (lane == 0) {
    red_s[warp] = wqmin;
    red_s[kWarps + warp] = wqmax;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qmin = min(qmin, red_s[w]);
    qmax = max(qmax, red_s[kWarps + w]);
  }

  auto issue = [&](int tile, int buf) {
    const int k0 = tile * kBK, valid = min(kBK, g.Sk - k0);
    stage<DP, kBK, kThreads>(Ks + buf * L::kK, kSQ, kh + k0 * g.k.s, g.k.s, valid, g.D, vec);
    stage<DP, kBK, kThreads>(Vs + buf * L::kV, kSV, vh + k0 * g.v.s, g.v.s, valid, g.D, vec);
    if (tid < kBK) {
      int* dst = kpos_s + buf * kBK + tid;
      if (tid < valid)
        repro::cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(kp + k0 + tid), true);
      else
        *dst = -1;  // keys past Sk are dead
    }
    repro::cp_async_commit();
  };

  const int n_tiles = (g.Sk + kBK - 1) / kBK;
  int n_live = scan_tiles<kWarps>(kp, 0, qmin, qmax, g, list_s, count_s);
  if (n_live > 0) issue(list_s[0], 0);

  float o[4][4 * kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kNC; ++c) o[i][c] = 0.f;
  float m[4], l[4];  // running max (log2 domain) and this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kMasked, l[i] = 0.f;
  const float sl = g.scale * kLog2e;
  const float* qrow = Qs + (warp * 16 + rg) * kSQ;
  float* Pw = smem + L::oP + warp * L::kP;

  for (int c0 = 0;;) {
    for (int i = 0; i < n_live; ++i) {
      const int buf = i & 1;
      repro::cp_async_wait_all();
      __syncthreads();  // tile i (and Q) has landed; every warp is done with tile i - 1's stage and P
      if (i + 1 < n_live) issue(list_s[i + 1], buf ^ 1);
      const float* kt = Ks + buf * L::kK;
      const float* vt = Vs + buf * L::kV;

      // the warp's view of the tile: no live pair (skip), or every pair live (no mask)
      const int kv = kpos_s[buf * kBK + lane];
      const int kmin = __reduce_min_sync(0xffffffffu, kv), kmax = __reduce_max_sync(0xffffffffu, kv);
      const int kmin_live = __reduce_min_sync(0xffffffffu, kv >= 0 ? kv : INT_MAX);
      if (wqmin > wqmax || kmax < 0 || (g.causal && kmin_live > wqmax) ||
          (g.use_window && (long long)kmax <= (long long)wqmin - g.window))
        continue;
      const bool full = kmin >= 0 && (!g.causal || kmax <= wqmin) &&
                        (!g.use_window || (long long)kmin > (long long)wqmax - g.window);

      // S = Q K^T: rows rg + 4i, keys kg + 8j; one ascending FMA chain per pair
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
      const float* krow = kt + kg * kSQ;
#pragma unroll 4
      for (int d = 0; d < DP; d += 4) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(qrow + 4 * a * kSQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(krow + 8 * j * kSQ + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[a][j] = __fmaf_rn(qa[a].x, kb[j].x, s[a][j]);
            s[a][j] = __fmaf_rn(qa[a].y, kb[j].y, s[a][j]);
            s[a][j] = __fmaf_rn(qa[a].z, kb[j].z, s[a][j]);
            s[a][j] = __fmaf_rn(qa[a].w, kb[j].w, s[a][j]);
          }
      }

      // scale into the log2 domain and mask
      if (full) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[a][j] *= sl;
      } else {
        int qv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = qpos_s[warp * 16 + rg + 4 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = __shfl_sync(0xffffffffu, kv, kg + 8 * j);
#pragma unroll
          for (int a = 0; a < 4; ++a) s[a][j] = masked(kj, qv[a], g) ? kMasked : s[a][j] * sl;
        }
      }

      // online softmax: the row max over the row's 8 lanes, P to the warp's buffer
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float mn = fmaxf(m[a], mx);
        const float corr = ex2(m[a] - mn);
        m[a] = mn;
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = ex2(s[a][j] - mn);
          ls += s[a][j];
        }
        l[a] = l[a] * corr + ls;
#pragma unroll
        for (int c = 0; c < 4 * kNC; ++c) o[a][c] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(Pw + (kg + 8 * j) * 16 + 4 * rg) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();

      // O += P V: per key one v4 of P (the lane's 4 rows) and kNC v4 of V
      const float* prow = Pw + 4 * rg;
      const float* vrow = vt + 4 * kg;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + kk * 16);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < kNC; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + kk * kSV + 32 * u);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            o[a][4 * u] = __fmaf_rn(p[a], w.x, o[a][4 * u]);
            o[a][4 * u + 1] = __fmaf_rn(p[a], w.y, o[a][4 * u + 1]);
            o[a][4 * u + 2] = __fmaf_rn(p[a], w.z, o[a][4 * u + 2]);
            o[a][4 * u + 3] = __fmaf_rn(p[a], w.w, o[a][4 * u + 3]);
          }
        }
      }
      // no barrier here: the next tile's __syncthreads comes before any stage or P is rewritten
    }
    c0 += kChunk;
    if (c0 >= n_tiles) break;
    n_live = scan_tiles<kWarps>(kp, c0, qmin, qmax, g, list_s, count_s);
    if (n_live > 0) issue(list_s[0], 0);
  }
  repro::cp_async_wait_all();  // Q, when no tile was live

  bool dead = false;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 4);
    dead |= warp * 16 + rg + 4 * a < rows && !(m[a] > kMasked);  // a row met a live key iff m left kMasked
  }
  if (__syncthreads_or(dead)) {
    // rows without a live key: the uniform mean of V over every key
    for (int c = tid; c < g.D; c += kThreads) {
      float sum = 0.f;
      for (long long key = 0; key < g.Sk; ++key) sum += to_f32(vh[key * g.v.s + c]);
      vmean[c] = sum / static_cast<float>(g.Sk);
    }
    __syncthreads();
  }
  T* oh = out + b * g.o.b + h * g.o.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = warp * 16 + rg + 4 * a;
    if (r >= rows) continue;
    const bool live = m[a] > kMasked;
    if (g.lse != nullptr && kg == 0)  // m is in the log2 domain: lse = (m + log2 l) ln 2
      g.lse[(size_t)bh * g.Sq + q0 + r] = live ? (m[a] + log2f(l[a])) * kLn2 : INFINITY;
    const float lc = fmaxf(l[a], 1e-30f);
    T* orow = oh + (q0 + r) * g.o.s;
#pragma unroll
    for (int u = 0; u < kNC; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 32 * u + 4 * kg + e;
        if (c < g.D) orow[c] = from_f32<T>(live ? __fdiv_rn(o[a][4 * u + e], lc) : vmean[c]);
      }
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out, Geometry g,
           cudaStream_t stream) {
  using L = Layout<DP>;
  const long long n_qblocks = (g.Sq + (long long)L::kBQ - 1) / L::kBQ;
  if (n_qblocks * g.BH > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  g.n_qblocks = static_cast<int>(n_qblocks);
  auto kernel = flash_panel_kernel<T, DP>;
  const cudaError_t e = repro::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<g.n_qblocks * g.BH, L::kThreads, L::kBytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                                 static_cast<const T*>(v), qpos, kpos,
                                                                 static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out,
             const Geometry& g, cudaStream_t stream) {
  if (g.D <= 32) return launch<T, 32>(q, k, v, qpos, kpos, out, g, stream);
  if (g.D <= 64) return launch<T, 64>(q, k, v, qpos, kpos, out, g, stream);
  if (g.D <= 128) return launch<T, 128>(q, k, v, qpos, kpos, out, g, stream);
  return launch<T, 256>(q, k, v, qpos, kpos, out, g, stream);
}

// Every row of a (n0, n1, n2, D) view of `elem`-byte values starts 16-byte
// aligned: the pointer, and each stride of an axis longer than 1, in whole
// 16 bytes.
bool rows_aligned16(const void* p, int elem, int n0, int n1, int n2, long long s0, long long s1, long long s2) {
  const int per = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (n0 == 1 || s0 % per == 0) && (n1 == 1 || s1 % per == 0) &&
         (n2 == 1 || s2 % per == 0);
}

template <typename T, int DP>
int plan(int* rows, int* blocks) {
  using L = Layout<DP>;
  auto kernel = flash_panel_kernel<T, DP>;
  const cudaError_t e = repro::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *rows = L::kBQ;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::kThreads, L::kBytes));
}

template <typename T>
int plan(int D, int* rows, int* blocks) {
  if (D <= 32) return plan<T, 32>(rows, blocks);
  if (D <= 64) return plan<T, 64>(rows, blocks);
  if (D <= 128) return plan<T, 128>(rows, blocks);
  return plan<T, 256>(rows, blocks);
}

}  // namespace

// The CUDA-core route of flash attention, with repro_flash_attention's
// arguments and limits: q (B, H, Sq, D), k and v (B, KV, Sk, D), out
// (B, H, Sq, D) as strided views (element strides for batch, head and
// sequence; features contiguous; no alignment beyond the element's), all
// f32 (dtype 0) or all bf16 (dtype 1); qpos (B, Sq) and kpos (B, Sk)
// contiguous int32.  H = KV * G, 1 <= D <= 256, Sk >= 1, B * H <= 65535.
// window is used when use_window.  lse: null, or (B, H, Sq) contiguous f32
// for the rows' log-sum-exp.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_panel(int dtype, const void* q, const void* k, const void* v,
                                           const void* qpos, const void* kpos, void* out, void* lse, int B, int H, int KV,
                                           int Sq, int Sk, int D, long long qsb, long long qsh, long long qss,
                                           long long ksb, long long ksh, long long kss, long long vsb,
                                           long long vsh, long long vss, long long osb, long long osh,
                                           long long oss, int causal, int use_window, int window, float scale,
                                           void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 256 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = D % (16 / elem) == 0 && rows_aligned16(q, elem, B, H, Sq, qsb, qsh, qss) &&
                   rows_aligned16(k, elem, B, KV, Sk, ksb, ksh, kss) && rows_aligned16(v, elem, B, KV, Sk, vsb, vsh, vss);
  const Geometry g{B * H, H, H / KV, Sq, Sk, D, 0, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                   {osb, osh, oss}, causal, use_window, window, scale, vec ? 1 : 0, static_cast<float*>(lse)};
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(q, k, v, qp, kp, out, g, s) : dispatch<bf16>(q, k, v, qp, kp, out, g, s);
}

// The query rows per block and the blocks one SM holds at once for a call
// of dtype (0 f32, 1 bf16) at head width D.  Returns a CUDA error code.
extern "C" int repro_flash_attention_panel_plan(int dtype, int D, int* rows_per_block, int* blocks_per_sm) {
  if ((dtype != 0 && dtype != 1) || D <= 0 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 0 ? plan<float>(D, rows_per_block, blocks_per_sm) : plan<bf16>(D, rows_per_block, blocks_per_sm);
}
