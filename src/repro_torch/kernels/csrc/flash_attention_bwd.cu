// The backward of attention with positional masks, on the CUDA cores in f32
// arithmetic, reading bf16 or f32.  It replaces no Pallas kernel: the JAX
// package trains through its jnp online softmax
// (repro/models/layers.py::_flash_sdpa) and lets JAX differentiate the
// lax.scan; the port's forward kernels (flash_attention_mma.cu,
// flash_attention_panel.cu) write through raw pointers, so their gradient
// is this kernel, in the FlashAttention-2 form.
//
// For query row r of head h (kv head h / G) and key c, with the forward's
// masks (dead key kpos < 0, causal kpos > qpos, window kpos <= qpos - window)
// and s = (q_r . k_c) / sqrt(D):
//   P_rc  = exp(s - lse_r) on a live pair, 0 on a masked one, where lse is
//           the row log-sum-exp the forward wrote;
//   D_r   = sum_d dO_rd O_rd                              (the pre-pass);
//   dP_rc = dO_r . v_c;   dS_rc = P_rc (dP_rc - D_r) on a live pair, else 0;
//   dV_c  = sum over the group's heads and rows of P_rc dO_r;
//   dK_c  = sum of dS_rc q_r / sqrt(D);   dQ_r = sum_c dS_rc k_c / sqrt(D).
// A row with no live key (lse = +inf) is the uniform mean of V in the
// forward: it adds dO_r / Sk to every key's dV and nothing to dQ or dK, as
// autograd through the plain version gives (its masked scores pass no
// gradient).
//
// Bound on the H100: operations.  The five products take 10 D FLOPs per live
// (query, key) pair and head (515.5 GFLOP for qwen2-1.5b's attention at
// S = 8192, causal: 7.69 ms at 67 TFLOP/s f32 off the tensor cores), while
// the tensors move 0.1 GB.  This first version runs in f32 on the CUDA cores
// (the tensor-core route is later work):
//
//  * Three launches on the caller's stream: the pre-pass (one warp a row),
//    the dK/dV kernel (one block per batch, kv head and block of BO keys,
//    looping over the G query heads of its group and over query tiles of
//    BT rows) and the dQ kernel (one block per batch, query head and block
//    of BO rows, looping over key tiles of BT keys).  Both recompute S and
//    dP from the inputs, the dK/dV kernel P from the saved lse.
//  * Each output element is summed by one thread in a fixed order, with no
//    atomic float add: every run gives the same bits.  The sums are f32 and
//    written once, in the input's dtype.
//  * Register tiles.  A block's own rows (keys, or queries) and the tile's
//    rows sit in shared memory as f32 rows of DP + 4 floats.  A thread owns
//    4 own rows: for S and dP it takes NT tile rows and runs 4 x NT dot
//    products of each kind on ld.shared.v4 loads; P and dS go to shared
//    memory tile-row-major, and for the sums it owns ND feature columns of
//    its 4 rows (dK and dV: 2 x 4 x ND accumulators, dQ: 4 x ND).
//  * Buckets by head width DP in {64, 128, 256} (zero-padded): 64 own rows
//    and 64 tile rows up to DP = 128 (170.5 KB of shared memory at 128);
//    32 own rows at DP = 256, so that the dK/dV accumulators still fit in
//    registers (219 KB).  256 threads, one block per SM.
//  * Tiles in which no pair can be live (and, for dK/dV, no row without a
//    live key sits) are skipped after their positions are read: exact, since
//    they add only zeros.
//  * The layout comes in as strides (the model's (B, S, heads, D) views),
//    and the kv head of query head h is h / G: no copy of anything.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // batch, head and sequence strides in elements; features are contiguous
};

struct Geometry {
  int H, KV, G, Sq, Sk, D, n_blocks, BH;
  Strides q, k, v, o, dout, dq, dk, dv;
  int causal, use_window, window;
  float scale;
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

// D_r = sum_d dO_rd O_rd in f32, one warp a row, lanes over the features in
// a fixed order.  delta is (B, H, Sq) contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, Geometry g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int r = blockIdx.x * (kThreads / 32) + warp;
  if (r >= g.Sq) return;
  const T* orow = o + b * g.o.b + h * g.o.h + r * g.o.s;
  const T* drow = dout + b * g.dout.b + h * g.dout.h + r * g.dout.s;
  float acc = 0.f;
  for (int c = lane; c < g.D; c += 32) acc = __fmaf_rn(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(size_t)bh * g.Sq + r] = acc;
}

// Shared memory of one block, in floats from the base: the own rows' two
// operands (A1, A2), the tile's two (B1, B2), P and dS tile-row-major
// (dK/dV only keeps P), the query rows' lse (log2 domain) and D, then the
// own and tile positions as ints.
template <int DP, int BO, int BT, bool kDKV>
struct Layout {
  static constexpr int kSS = DP + 4;  // floats per operand row: consecutive rows start 4 banks apart
  static constexpr int kSW = BO + 4;  // floats per P / dS row
  static constexpr int kKG = BO / 4;  // groups of 4 own rows
  static constexpr int kTX = kThreads / kKG;  // threads per group
  static constexpr int kNT = BT / kTX;        // tile rows per thread for S and dP
  static constexpr int kND = DP / kTX;        // feature columns per thread for the sums
  static constexpr int kBR = kDKV ? BT : BO;  // the query rows whose lse and D a block reads
  static constexpr int oA2 = BO * kSS, oB1 = 2 * BO * kSS, oB2 = oB1 + BT * kSS, oP = oB2 + BT * kSS;
  static constexpr int oS = oP + (kDKV ? BT * kSW : 0), oL = oS + BT * kSW, oD = oL + kBR, oInts = oD + kBR;
  static constexpr size_t kBytes = sizeof(float) * oInts + sizeof(int) * (BO + BT);
  static_assert(kKG * kTX == kThreads && kNT * kTX == BT && kND * kTX == DP && kND % 4 == 0, "tile shape");
  static_assert(kBytes <= 232448, "shared memory");
};

// rows [0, kRows) of a strided (rows, D) view into shared rows of kSS
// floats, zero past `valid` rows and from D to DP.  Call with the whole
// block; the caller synchronises.
template <typename T, int DP, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, long long stride, int valid, int D) {
  constexpr int kSS = DP + 4;
#pragma unroll 4
  for (int t = threadIdx.x; t < kRows * DP; t += kThreads) {
    const int r = t / DP, c = t % DP;
    dst[r * kSS + c] = r < valid && c < D ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// One block of the dK/dV kernel (kDKV: own rows are keys, the tiles are
// query rows of the group's G heads) or of the dQ kernel (own rows are
// queries of one head, the tiles are keys).
template <typename T, int DP, int BO, int BT, bool kDKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
                 const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, Geometry g) {
  using L = Layout<DP, BO, BT, kDKV>;
  constexpr int kSS = L::kSS, kSW = L::kSW, kTX = L::kTX, kNT = L::kNT, kND = L::kND;
  extern __shared__ __align__(16) float smem[];
  float* A1 = smem;
  float* A2 = smem + L::oA2;
  float* B1 = smem + L::oB1;
  float* B2 = smem + L::oB2;
  float* Ps = smem + L::oP;
  float* Ss = smem + L::oS;
  float* row_l = smem + L::oL;
  float* row_d = smem + L::oD;
  int* own_pos = reinterpret_cast<int*>(smem + L::oInts);
  int* tile_pos = own_pos + BO;

  const int tid = threadIdx.x, og = tid / kTX, tx = tid % kTX;
  // dK/dV: early key blocks see the most queries (causal) and go first;
  // dQ: late query blocks see the most keys and go first
  const int blk = kDKV ? blockIdx.x / g.BH : g.n_blocks - 1 - blockIdx.x / g.BH;
  const int bh = blockIdx.x % g.BH;  // (batch, kv head) or (batch, query head)
  const int heads = kDKV ? g.KV : g.H, b = bh / heads, hh = bh - b * heads;
  const int own0 = blk * BO, S_own = kDKV ? g.Sk : g.Sq, S_tile = kDKV ? g.Sq : g.Sk;
  const int n_own = min(BO, S_own - own0);
  const int* qp_b = qpos + (size_t)b * g.Sq;
  const int* kp_b = kpos + (size_t)b * g.Sk;
  const float sl = g.scale * kLog2e;

  // own rows: K and V (dK/dV) or Q and dO (dQ, with their lse and D)
  const T *a1_src, *a2_src;
  long long a1_s, a2_s;
  if (kDKV) {
    a1_src = k + b * g.k.b + hh * g.k.h + own0 * g.k.s, a1_s = g.k.s;
    a2_src = v + b * g.v.b + hh * g.v.h + own0 * g.v.s, a2_s = g.v.s;
  } else {
    a1_src = q + b * g.q.b + hh * g.q.h + own0 * g.q.s, a1_s = g.q.s;
    a2_src = dout + b * g.dout.b + hh * g.dout.h + own0 * g.dout.s, a2_s = g.dout.s;
  }
  stage<T, DP, BO>(A1, a1_src, a1_s, n_own, g.D);
  stage<T, DP, BO>(A2, a2_src, a2_s, n_own, g.D);
  if (tid < BO) {
    const bool ok = tid < n_own;
    own_pos[tid] = kDKV ? (ok ? kp_b[own0 + tid] : -1) : (ok ? qp_b[own0 + tid] : 0);
    if (!kDKV) {
      const size_t row = (size_t)bh * g.Sq + own0 + tid;
      row_l[tid] = ok ? lse[row] * kLog2e : 0.f;
      row_d[tid] = ok ? delta[row] : 0.f;
    }
  }
  __syncthreads();
  // the own rows' position range, for skipping tiles: live keys (dK/dV) or
  // real query rows (dQ)
  int pmin = INT_MAX, pmax = INT_MIN;
  for (int r = 0; r < n_own; ++r) {
    const int p = own_pos[r];
    if (!kDKV || p >= 0) {
      pmin = min(pmin, p);
      pmax = max(pmax, p);
    }
  }

  float acc1[4][kND], acc2[4][kND];  // dV and dK (dK/dV), dQ in acc2 (dQ)
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kND; ++c) acc1[a][c] = acc2[a][c] = 0.f;

  const int n_tiles = (S_tile + BT - 1) / BT;
  const int n_heads = kDKV ? g.G : 1;
  const float inv_sk = 1.f / static_cast<float>(g.Sk);
  for (int gi = 0; gi < n_heads; ++gi) {
    const int h = kDKV ? hh * g.G + gi : hh;  // the query head
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * BT, n_tile = min(BT, S_tile - t0);
      __syncthreads();  // the previous tile's operands, P and dS are no longer read
      bool visit = false;
      if (tid < BT) {
        const bool ok = tid < n_tile;
        if (kDKV) {  // a query row: live with some own key, or with no live key at all (lse = +inf)
          const size_t row = (size_t)(b * g.H + h) * g.Sq + t0 + tid;
          const int p = ok ? qp_b[t0 + tid] : 0;
          const float l = ok ? lse[row] : 0.f;
          tile_pos[tid] = p;
          row_l[tid] = l * kLog2e;
          row_d[tid] = ok ? delta[row] : 0.f;
          visit = ok && (isinf(l) || (pmax >= 0 && (!g.causal || pmin <= p) &&
                                      (!g.use_window || (long long)pmax > (long long)p - g.window)));
        } else {  // a key: live with some own query row
          const int p = ok ? kp_b[t0 + tid] : -1;
          tile_pos[tid] = p;
          visit = p >= 0 && pmin <= pmax && (!g.causal || p <= pmax) &&
                  (!g.use_window || (long long)p > (long long)pmin - g.window);
        }
      }
      if (!__syncthreads_or(visit)) continue;
      if (kDKV) {
        stage<T, DP, BT>(B1, q + b * g.q.b + h * g.q.h + t0 * g.q.s, g.q.s, n_tile, g.D);
        stage<T, DP, BT>(B2, dout + b * g.dout.b + h * g.dout.h + t0 * g.dout.s, g.dout.s, n_tile, g.D);
      } else {
        const int kvh = h / g.G;
        stage<T, DP, BT>(B1, k + b * g.k.b + kvh * g.k.h + t0 * g.k.s, g.k.s, n_tile, g.D);
        stage<T, DP, BT>(B2, v + b * g.v.b + kvh * g.v.h + t0 * g.v.s, g.v.s, n_tile, g.D);
      }
      __syncthreads();

      // S = A1 B1^T and dP = A2 B2^T: own rows og*4 + a, tile rows tx + kTX*c
      float s[4][kNT], dp[4][kNT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kNT; ++c) s[a][c] = dp[a][c] = 0.f;
      const float* a1 = A1 + og * 4 * kSS;
      const float* a2 = A2 + og * 4 * kSS;
      const float* b1 = B1 + tx * kSS;
      const float* b2 = B2 + tx * kSS;
#pragma unroll 1  // 16 v4 loads feed 32 kNT FMAs; unrolled, the loads' registers would crowd the sums'
      for (int d = 0; d < DP; d += 4) {
        float4 x1[4], x2[4], y1[kNT], y2[kNT];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          x1[a] = *reinterpret_cast<const float4*>(a1 + a * kSS + d);
          x2[a] = *reinterpret_cast<const float4*>(a2 + a * kSS + d);
        }
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          y1[c] = *reinterpret_cast<const float4*>(b1 + c * kTX * kSS + d);
          y2[c] = *reinterpret_cast<const float4*>(b2 + c * kTX * kSS + d);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kNT; ++c) {
            s[a][c] = __fmaf_rn(x1[a].x, y1[c].x, s[a][c]);
            s[a][c] = __fmaf_rn(x1[a].y, y1[c].y, s[a][c]);
            s[a][c] = __fmaf_rn(x1[a].z, y1[c].z, s[a][c]);
            s[a][c] = __fmaf_rn(x1[a].w, y1[c].w, s[a][c]);
            dp[a][c] = __fmaf_rn(x2[a].x, y2[c].x, dp[a][c]);
            dp[a][c] = __fmaf_rn(x2[a].y, y2[c].y, dp[a][c]);
            dp[a][c] = __fmaf_rn(x2[a].z, y2[c].z, dp[a][c]);
            dp[a][c] = __fmaf_rn(x2[a].w, y2[c].w, dp[a][c]);
          }
      }

      // P and dS, tile-row-major: a v4 of the thread's 4 own rows per tile row
#pragma unroll
      for (int c = 0; c < kNT; ++c) {
        const int tr = tx + kTX * c;
        float p[4], ds[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int orow = og * 4 + a;
          const int kp = kDKV ? own_pos[orow] : tile_pos[tr];
          const int qp = kDKV ? tile_pos[tr] : own_pos[orow];
          const float l2 = kDKV ? row_l[tr] : row_l[orow];
          const float dl = kDKV ? row_d[tr] : row_d[orow];
          p[a] = ds[a] = 0.f;
          if (orow < n_own && tr < n_tile) {
            if (!masked(kp, qp, g)) {
              p[a] = ex2(__fmaf_rn(s[a][c], sl, -l2));
              ds[a] = p[a] * (dp[a][c] - dl);
            } else if (kDKV && isinf(l2)) {
              p[a] = inv_sk;  // a row with no live key: the uniform weights of the forward's mean
            }
          }
        }
        if (kDKV) *reinterpret_cast<float4*>(Ps + tr * kSW + og * 4) = make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(Ss + tr * kSW + og * 4) = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q (dK/dV), dQ += dS K (dQ): columns 4 tx + 4 kTX u + e
#pragma unroll 2
      for (int tr = 0; tr < n_tile; ++tr) {
        const float4 w2 = *reinterpret_cast<const float4*>(Ss + tr * kSW + og * 4);
        const float ws2[4] = {w2.x, w2.y, w2.z, w2.w};
        float ws1[4] = {0.f, 0.f, 0.f, 0.f};
        if (kDKV) {
          const float4 w1 = *reinterpret_cast<const float4*>(Ps + tr * kSW + og * 4);
          ws1[0] = w1.x, ws1[1] = w1.y, ws1[2] = w1.z, ws1[3] = w1.w;
        }
#pragma unroll
        for (int u = 0; u < kND / 4; ++u) {
          const int col = 4 * tx + 4 * kTX * u;
          const float4 y1 = *reinterpret_cast<const float4*>(B1 + tr * kSS + col);  // Q (dK/dV) or K (dQ)
          float4 y2 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kDKV) y2 = *reinterpret_cast<const float4*>(B2 + tr * kSS + col);  // dO
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc2[a][4 * u] = __fmaf_rn(ws2[a], y1.x, acc2[a][4 * u]);
            acc2[a][4 * u + 1] = __fmaf_rn(ws2[a], y1.y, acc2[a][4 * u + 1]);
            acc2[a][4 * u + 2] = __fmaf_rn(ws2[a], y1.z, acc2[a][4 * u + 2]);
            acc2[a][4 * u + 3] = __fmaf_rn(ws2[a], y1.w, acc2[a][4 * u + 3]);
            if (kDKV) {
              acc1[a][4 * u] = __fmaf_rn(ws1[a], y2.x, acc1[a][4 * u]);
              acc1[a][4 * u + 1] = __fmaf_rn(ws1[a], y2.y, acc1[a][4 * u + 1]);
              acc1[a][4 * u + 2] = __fmaf_rn(ws1[a], y2.z, acc1[a][4 * u + 2]);
              acc1[a][4 * u + 3] = __fmaf_rn(ws1[a], y2.w, acc1[a][4 * u + 3]);
            }
          }
        }
      }
    }
  }

  // write the thread's 4 rows x kND columns, dS sums times 1/sqrt(D)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int orow = og * 4 + a;
    if (orow >= n_own) continue;
    const long long r = own0 + orow;
    T* out2 = kDKV ? dk + b * g.dk.b + hh * g.dk.h + r * g.dk.s : dq + b * g.dq.b + hh * g.dq.h + r * g.dq.s;
    T* out1 = kDKV ? dv + b * g.dv.b + hh * g.dv.h + r * g.dv.s : nullptr;
#pragma unroll
    for (int u = 0; u < kND / 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 4 * kTX * u + e;
        if (col >= g.D) continue;
        out2[col] = from_f32<T>(acc2[a][4 * u + e] * g.scale);
        if (kDKV) out1[col] = from_f32<T>(acc1[a][4 * u + e]);
      }
  }
}

template <typename T, int DP, int BO, int BT, bool kDKV>
int launch_main(const T* q, const T* k, const T* v, const T* dout, const int* qpos, const int* kpos,
                const float* lse, const float* delta, T* dq, T* dk, T* dv, Geometry g, int batch,
                cudaStream_t stream) {
  using L = Layout<DP, BO, BT, kDKV>;
  g.BH = batch * (kDKV ? g.KV : g.H);
  const long long n_blocks = ((kDKV ? g.Sk : g.Sq) + (long long)BO - 1) / BO;
  if (n_blocks * g.BH > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  g.n_blocks = static_cast<int>(n_blocks);
  auto kernel = flash_bwd_kernel<T, DP, BO, BT, kDKV>;
  const cudaError_t e = repro::allow_smem(kernel, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<g.n_blocks * g.BH, kThreads, L::kBytes, stream>>>(q, k, v, dout, qpos, kpos, lse, delta, dq, dk, dv, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int BO>
int run(const T* q, const T* k, const T* v, const T* o, const T* dout, const int* qpos, const int* kpos,
        const float* lse, float* delta, T* dq, T* dk, T* dv, const Geometry& g, int batch, cudaStream_t stream) {
  const dim3 grid((g.Sq + kThreads / 32 - 1) / (kThreads / 32), batch * g.H);
  delta_kernel<T><<<grid, kThreads, 0, stream>>>(o, dout, delta, g);
  int code = static_cast<int>(cudaGetLastError());
  if (code == 0)
    code = launch_main<T, DP, BO, 64, true>(q, k, v, dout, qpos, kpos, lse, delta, dq, dk, dv, g, batch, stream);
  if (code == 0)
    code = launch_main<T, DP, BO, 64, false>(q, k, v, dout, qpos, kpos, lse, delta, dq, dk, dv, g, batch, stream);
  return code;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout, const int* qpos,
             const int* kpos, const float* lse, float* delta, void* dq, void* dk, void* dv, const Geometry& g,
             int batch, cudaStream_t s) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
  if (g.D <= 64)
    return run<T, 64, 64>(c(q), c(k), c(v), c(o), c(dout), qpos, kpos, lse, delta, m(dq), m(dk), m(dv), g, batch, s);
  if (g.D <= 128)
    return run<T, 128, 64>(c(q), c(k), c(v), c(o), c(dout), qpos, kpos, lse, delta, m(dq), m(dk), m(dv), g, batch,
                           s);
  return run<T, 256, 32>(c(q), c(k), c(v), c(o), c(dout), qpos, kpos, lse, delta, m(dq), m(dk), m(dv), g, batch, s);
}

}  // namespace

// The backward of repro_flash_attention_mma / _panel: q, o, dout and dq
// (B, H, Sq, D), k, v, dk and dv (B, KV, Sk, D) as strided views (element
// strides for batch, head and sequence; features contiguous), all f32
// (dtype 0) or all bf16 (dtype 1); qpos (B, Sq) and kpos (B, Sk) contiguous
// int32; lse (B, H, Sq) contiguous f32 as the forward wrote it; delta a
// (B, H, Sq) f32 scratch.  H = KV * G, 1 <= D <= 256, Sq, Sk >= 1,
// B * H <= 65535.  Three launches on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* qpos, const void* kpos, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
                                         int Sk, int D, long long qsb, long long qsh, long long qss, long long ksb,
                                         long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                                         long long osb, long long osh, long long oss, long long dosb,
                                         long long dosh, long long doss, long long dqsb, long long dqsh,
                                         long long dqss, long long dksb, long long dksh, long long dkss,
                                         long long dvsb, long long dvsh, long long dvss, int causal, int use_window,
                                         int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 256 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{H, KV, H / KV, Sq, Sk, D, 0, 0, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                   {osb, osh, oss}, {dosb, dosh, doss}, {dqsb, dqsh, dqss}, {dksb, dksh, dkss}, {dvsb, dvsh, dvss},
                   causal, use_window, window, scale};
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(q, k, v, o, dout, qp, kp, l, dl, dq, dk, dv, g, B, s)
                    : dispatch<bf16>(q, k, v, o, dout, qp, kp, l, dl, dq, dk, dv, g, B, s);
}
