// Forward attention with positional masks on the tensor cores, bf16 only
// (the port of the JAX package's Pallas kernel
// repro/kernels/flash_attention.py::_flash_kernel; the CUDA-core kernel in
// flash_attention.cu keeps serving f32 and the views this one refuses).
//
// For query row r of head h and key c of its kv head h / G:
//   s = (q_r . k_c) / sqrt(D), or -1e30 where the key is dead (kpos < 0),
//   in the future (causal, kpos > qpos) or out of the window
//   (kpos <= qpos - window);
//   out_r = softmax(s) V, stored in bf16.
// A row with no live key gets the uniform mean of V over the Sk keys.
// Where the caller passes lse (training), the kernel also writes the row's
// log-sum-exp of the scaled scores, lse_r = log sum_c exp(s), in f32 from the
// (m, l) it keeps anyway; a row with no live key gets +inf there (the
// backward's mark for such a row).  With a null lse nothing else changes.
//
// Bound on the H100: operations.  QK^T and PV take 4 D FLOPs per live
// (query, key) pair and head, at 989 TFLOP/s dense bf16 (51.5 GFLOP, 52 us,
// for qwen2-1.5b's attention at S = 4096), while q, k, v and the output move
// 29 MB (9 us at 3.35 TB/s).  So the products belong on the tensor cores,
// fed from shared memory fast enough to keep them busy.
//
// Design (FlashAttention-2 on warp-level mma.sync):
// - One block of 4 warps per (batch x query head, 64 query rows); each warp
//   owns 16 rows and keeps their Q fragments in registers for the sweep.
// - Keys go in tiles of 64.  cp.async (16-byte .cg copies) fills a ring of
//   two K/V tiles in shared memory, so the next tile is in flight while the
//   block computes on this one.  Rows are padded by 16 bytes so ldmatrix
//   reads hit distinct banks; D is padded with zeros to DP, a multiple of 16
//   (template: 16, 32, 64, 128).
// - S = Q K^T from mma.sync.m16n8k16 (bf16 in, f32 accumulate), K fragments
//   by ldmatrix.  The masks are applied to the S fragments in registers from
//   the staged kpos (skipped where the warp sees only live pairs); the row
//   max and sum run across the quad with shfl_xor 1 and 2.
// - P enters PV as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so
//   the product carries p to 2^-17 and l is summed from the f32 p.  P
//   rounded once to bf16 (the Pallas kernel's p.astype(v.dtype)) is off by
//   up to 2^-9 relative per weight: on rows with a few live keys whose
//   values cancel that is more than the output's own bf16 rounding, and
//   more than the port's attention check allows.  The lo term doubles PV's
//   tensor-core work (half again the kernel's) and adds no shared-memory
//   reads: both terms meet the same V fragment.  The S accumulator fragments are PV's
//   A fragments as they stand, so P never goes through shared memory; V
//   fragments come from ldmatrix.trans.
// - A pre-scan of kpos lists the tiles in which some (query, key) pair of
//   the block can be live; the sweep visits only those.  Rows that never
//   meet a live key take the mean of V from a separate sweep, so skipping
//   never changes a result.
// - The kv head is read at h / G and the layout comes in as strides: no
//   K/V copy per query head, no head-major copy.  Heavy (late) q blocks of
//   every head launch first.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per tile
constexpr int kChunk = 512;       // tiles listed per pre-scan (32,768 keys)
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
  float* lse;  // (B, H, Sq) contiguous f32, or null
};

template <int DP>
struct Tile {
  static constexpr int kStride = DP + 8;      // bf16 per shared row: +16 bytes against bank conflicts
  static constexpr int kElems = kBK * kStride;  // one K or V tile
  static constexpr int kChunks = DP / 8;      // 16-byte copies per row
  static constexpr size_t kBytes = sizeof(bf16) * ((size_t)kBQ * kStride + 4 * (size_t)kElems) +
                                   sizeof(int) * (2 * kBK + kChunk + 2 * kWarps + 1) + sizeof(float) * DP;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo to 2^-17 relative, each term a bf16 pair packed as above.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ bool masked(int kp, int qp, const Geometry& g) {
  return kp < 0 || (g.causal && kp > qp) || (g.use_window && (long long)kp <= (long long)qp - g.window);
}

// List, in list_s, the tiles [c0, c0 + kChunk) in which some (query, key)
// pair of the block can be live, and return how many.  Call with the whole
// block; ends synchronised.
__device__ __forceinline__ int scan_tiles(const int* __restrict__ kp, int c0, int qmin, int qmax,
                                          const Geometry& g, int* list_s, int* count_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = min(kChunk, (g.Sk + kBK - 1) / kBK - c0);
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int key = (c0 + t) * kBK + lane;
    bool any = false;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kv = key + 32 * half < g.Sk ? kp[key + 32 * half] : -1;
      any |= kv >= 0 && (!g.causal || kv <= qmax) &&
             (!g.use_window || (long long)kv > (long long)qmin - g.window);
    }
    any = __any_sync(0xffffffffu, any);
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const int* __restrict__ qpos, const int* __restrict__ kpos, bf16* __restrict__ out,
                 Geometry g) {
  using T = Tile<DP>;
  constexpr int kStride = T::kStride, kChunks = T::kChunks, kNT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x kStride
  bf16* Ks = Qs + kBQ * kStride;                 // 2 tiles
  bf16* Vs = Ks + 2 * T::kElems;                 // 2 tiles
  int* kpos_s = reinterpret_cast<int*>(Vs + 2 * T::kElems);  // 2 x kBK
  int* list_s = kpos_s + 2 * kBK;                            // kChunk
  int* red_s = list_s + kChunk;                              // 2 x kWarps
  int* count_s = red_s + 2 * kWarps;
  float* vmean = reinterpret_cast<float*>(count_s + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, quad = lane & 3;
  const int bh = blockIdx.x % g.BH;
  const int q0 = (g.n_qblocks - 1 - blockIdx.x / g.BH) * kBQ;  // heavy (late) blocks first
  const int b = bh / g.H, h = bh - b * g.H, kvh = h / g.G;
  const bf16* qh = q + b * g.q.b + h * g.q.h;
  const bf16* kh = k + b * g.k.b + kvh * g.k.h;
  const bf16* vh = v + b * g.v.b + kvh * g.v.h;
  bf16* oh = out + b * g.o.b + h * g.o.h;
  const int* qp = qpos + (size_t)b * g.Sq;
  const int* kp = kpos + (size_t)b * g.Sk;
  const int rows = min(kBQ, g.Sq - q0);

  // Q -> shared, zero past Sq and past D
#pragma unroll
  for (int t = tid; t < kBQ * kChunks; t += kThreads) {
    const int r = t / kChunks, c = t % kChunks;
    const bool ok = r < rows && c * 8 < g.D;
    cp_async16(smem_u32(Qs + r * kStride + c * 8), ok ? qh + (q0 + r) * g.q.s + c * 8 : qh, ok);
  }
  cp_async_commit();

  // this thread's rows r0 and r1 = r0 + 8, and the query position ranges of
  // the warp's and the block's real rows
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qp0 = r0 < rows ? qp[q0 + r0] : 0, qp1 = r1 < rows ? qp[q0 + r1] : 0;
  const int wqmin = __reduce_min_sync(0xffffffffu, min(r0 < rows ? qp0 : INT_MAX, r1 < rows ? qp1 : INT_MAX));
  const int wqmax = __reduce_max_sync(0xffffffffu, max(r0 < rows ? qp0 : INT_MIN, r1 < rows ? qp1 : INT_MIN));
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

  const int n_tiles = (g.Sk + kBK - 1) / kBK;
  int n_live = scan_tiles(kp, 0, qmin, qmax, g, list_s, count_s);

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];  // A fragments of the warp's 16 rows
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    ldsm_x4(smem_u32(Qs + (warp * 16 + (lane & 15)) * kStride + 16 * kk + ((lane >> 4) << 3)), qf[kk]);

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
  const float sl = g.scale * kLog2e;                     // scores in the log2 domain

  auto issue = [&](int tile, int buf) {
    const int k0 = tile * kBK;
    bf16* kd = Ks + buf * T::kElems;
    bf16* vd = Vs + buf * T::kElems;
#pragma unroll
    for (int t = tid; t < kBK * kChunks; t += kThreads) {
      const int r = t / kChunks, c = t % kChunks;
      const bool ok = k0 + r < g.Sk && c * 8 < g.D;
      const long long key = k0 + r;
      cp_async16(smem_u32(kd + r * kStride + c * 8), ok ? kh + key * g.k.s + c * 8 : kh, ok);
      cp_async16(smem_u32(vd + r * kStride + c * 8), ok ? vh + key * g.v.s + c * 8 : vh, ok);
    }
    if (tid < kBK) {
      int* dst = kpos_s + buf * kBK + tid;
      if (k0 + tid < g.Sk)
        cp_async4(smem_u32(dst), kp + k0 + tid);
      else
        *dst = -1;  // keys past Sk are dead
    }
    cp_async_commit();
  };

  for (int c0 = 0;;) {
    if (n_live > 0) issue(list_s[0], 0);
    for (int i = 0; i < n_live; ++i) {
      const int buf = i & 1;
      if (i + 1 < n_live) {
        issue(list_s[i + 1], buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* kt = Ks + buf * T::kElems;
      const bf16* vt = Vs + buf * T::kElems;
      const int* kps = kpos_s + buf * kBK;

      // is every (row, key) pair of this warp live?  Then no mask is needed.
      const int ka = kps[lane], kb = kps[lane + 32];
      const int kmin = __reduce_min_sync(0xffffffffu, min(ka, kb));
      const int kmax = __reduce_max_sync(0xffffffffu, max(ka, kb));
      const bool full = kmin >= 0 && (!g.causal || kmax <= wqmin) &&
                        (!g.use_window || (long long)kmin > (long long)wqmax - g.window);

      // S = Q K^T: 8 n-tiles of 8 keys, rows r0 (s[j][0..1]) and r1 (s[j][2..3])
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t bk[4];
          ldsm_x4(smem_u32(kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * kStride + 16 * kk +
                           (((lane >> 3) & 1) << 3)),
                  bk);
          mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
        }
      }

      // scale and mask; element (j, e) is key 8j + 2 quad + (e & 1)
      if (full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= sl;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(kps + 8 * j + 2 * quad);
          s[j][0] = masked(kv.x, qp0, g) ? kMasked : s[j][0] * sl;
          s[j][1] = masked(kv.y, qp0, g) ? kMasked : s[j][1] * sl;
          s[j][2] = masked(kv.x, qp1, g) ? kMasked : s[j][2] * sl;
          s[j][3] = masked(kv.y, qp1, g) ? kMasked : s[j][3] * sl;
        }
      }

      // online softmax over the tile
      float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2(s[j][0] - mn0);
        s[j][1] = ex2(s[j][1] - mn0);
        s[j][2] = ex2(s[j][2] - mn1);
        s[j][3] = ex2(s[j][3] - mn1);
        ls0 += s[j][0] + s[j][1];
        ls1 += s[j][2] + s[j][3];
      }
      l0 = l0 * corr0 + ls0;
      l1 = l1 * corr1 + ls1;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[n][0] *= corr0;
        o[n][1] *= corr0;
        o[n][2] *= corr1;
        o[n][3] *= corr1;
      }

      // O += P V: P as hi + lo bf16 terms straight from the S fragments, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(smem_u32(vt + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + 16 * dp +
                                 ((lane >> 4) << 3)),
                        bv);
          mma_bf16(o[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
      __syncthreads();  // this buffer is refilled two tiles on
    }
    c0 += kChunk;
    if (c0 >= n_tiles) break;
    n_live = scan_tiles(kp, c0, qmin, qmax, g, list_s, count_s);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row met a live key iff its running max left the masked value
  const bool live0 = m0 > kMasked, live1 = m1 > kMasked;
  if (__syncthreads_or((r0 < rows && !live0) || (r1 < rows && !live1))) {
    // rows without a live key: the uniform mean of V over every key
    for (int c = tid; c < g.D; c += kThreads) {
      float sum = 0.f;
      for (long long key = 0; key < g.Sk; ++key) sum += __bfloat162float(vh[key * g.v.s + c]);
      vmean[c] = sum / static_cast<float>(g.Sk);
    }
    __syncthreads();
  }
  if (g.lse != nullptr && quad == 0) {  // m is in the log2 domain: lse = (m + log2 l) ln 2
    float* lrow = g.lse + (size_t)bh * g.Sq + q0;
    if (r0 < rows) lrow[r0] = live0 ? (m0 + log2f(l0)) * kLn2 : INFINITY;
    if (r1 < rows) lrow[r1] = live1 ? (m1 + log2f(l1)) * kLn2 : INFINITY;
  }
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  bf16* orow0 = oh + (q0 + r0) * g.o.s;
  bf16* orow1 = oh + (q0 + r1) * g.o.s;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int c = 8 * n + 2 * quad;
    if (8 * n >= g.D) break;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(orow0 + c) =
          live0 ? pack_bf16(__fdiv_rn(o[n][0], lc0), __fdiv_rn(o[n][1], lc0)) : pack_bf16(vmean[c], vmean[c + 1]);
    if (r1 < rows)
      *reinterpret_cast<uint32_t*>(orow1 + c) =
          live1 ? pack_bf16(__fdiv_rn(o[n][2], lc1), __fdiv_rn(o[n][3], lc1)) : pack_bf16(vmean[c], vmean[c + 1]);
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos, void* out,
           const Geometry& g, cudaStream_t stream) {
  const size_t smem = Tile<DP>::kBytes;
  auto kernel = flash_mma_kernel<DP>;
  const cudaError_t e = repro::allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<g.n_qblocks * g.BH, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qpos, kpos,
      static_cast<bf16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route of repro_flash_attention, with the same arguments:
// q (B, H, Sq, D), k and v (B, KV, Sk, D), out (B, H, Sq, D) as strided
// bf16 views (dtype 1 only; element strides for batch, head and sequence,
// features contiguous); qpos (B, Sq) and kpos (B, Sk) contiguous int32.
// H = KV * G, D <= 128 and a multiple of 8, every pointer 16-byte aligned
// and every stride a multiple of 8 elements (the caller checks those two:
// the 16-byte copies need them).  lse: null, or (B, H, Sq) contiguous f32
// for the rows' log-sum-exp.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention_mma(int dtype, const void* q, const void* k, const void* v,
                                         const void* qpos, const void* kpos, void* out, void* lse, int B, int H,
                                         int KV, int Sq, int Sk, int D, long long qsb, long long qsh,
                                         long long qss, long long ksb, long long ksh, long long kss,
                                         long long vsb, long long vsh, long long vss, long long osb,
                                         long long osh, long long oss, int causal, int use_window,
                                         int window, float scale, void* stream) {
  const long long n_qblocks = (Sq + (long long)kBQ - 1) / kBQ;
  if (dtype != 1 || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0 || n_qblocks * B * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{B * H, H, H / KV, Sq, Sk, D, static_cast<int>(n_qblocks), {qsb, qsh, qss}, {ksb, ksh, kss},
             {vsb, vsh, vss}, {osb, osh, oss}, causal, use_window, window, scale, static_cast<float*>(lse)};
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(q, k, v, qp, kp, out, g, s);
  if (D <= 32) return launch<32>(q, k, v, qp, kp, out, g, s);
  if (D <= 64) return launch<64>(q, k, v, qp, kp, out, g, s);
  return launch<128>(q, k, v, qp, kp, out, g, s);
}
