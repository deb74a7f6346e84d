// The backward of attention with positional masks on the tensor cores, bf16
// only (the tensor-core route of flash_attention_bwd.cu, which keeps serving
// f32, head widths past 128 and the views the 16-byte copies refuse, and is
// this kernel's oracle on the card).  It replaces no Pallas kernel: the JAX
// package trains through its jnp online softmax
// (repro/models/layers.py::_flash_sdpa) and lets JAX differentiate the
// lax.scan; the port's forward kernels write through raw pointers, so their
// gradient is a kernel of its own, in the FlashAttention-2 form.
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
// forward: it adds dO_r / Sk to every key's dV and nothing to dQ or dK.
//
// Bound on the H100: operations.  The five products take 10 D FLOPs per live
// (query, key) pair and head: 515.5 GFLOP for qwen2-1.5b's attention at
// S = 8192, causal, 0.52 ms at 989 TFLOP/s dense bf16, while the tensors move
// 0.1 GB (0.03 ms at 3.35 TB/s).  So the products belong on the tensor cores.
//
// Design (FlashAttention-2's backward on warp-level mma.sync, no atomics):
// - Three launches: the pre-pass (D in f32, one warp a row) and the dK/dV
//   kernel on the caller's stream, the dQ kernel beside the dK/dV kernel on
//   a second stream of the library's, fenced by events both ways.  Under a
//   causal mask the dK/dV blocks' sweeps differ by the whole sequence (the
//   first key block meets every query row): the dQ blocks fill the SMs that
//   the short ones leave.  Both kernels recompute S and dP from the inputs
//   and P from the saved lse, so S and dP are computed twice: 14 D FLOPs
//   executed per live pair for the 10 D of the products.
// - dK/dV: one block of 4 warps per (batch, kv head, 64 keys); each warp owns
//   16 keys.  The block's K and V sit in shared memory (bf16) for the whole
//   sweep over the G query heads of its group and their query tiles of BT
//   rows; Q, dO, the rows' positions, lse and D arrive through a two-stage
//   ring of cp.async copies.  S^T = K Q^T and dP^T = V dO^T come from
//   mma.sync.m16n8k16 (bf16 in, f32 sums), Q and dO fragments by ldmatrix.
//   P^T = 2^(S^T scale log2e - lse log2e) and dS^T = P^T o (dP^T - D) are
//   computed on the accumulator fragments, which are then the A fragments of
//   dV += P^T dO and dK += dS^T Q as they stand (B by ldmatrix.trans): P and
//   dS never touch shared memory.  dK and dV stay in f32 registers and are
//   written once, dK times 1/sqrt(D).
// - dQ: one block of 4 warps per (batch, query head, 64 rows); each warp
//   owns 16 rows and keeps their Q fragments, lse and D in registers (dO's
//   fragments come from shared memory per tile).  K and V tiles arrive
//   through the ring; S = Q K^T, dP = dO V^T, dS from those, dQ += dS K
//   with K by ldmatrix.trans.
// - Precision: P (into dV) and dS (into dK and dQ) enter the products as two
//   bf16 terms, hi = bf16(x) and lo = bf16(x - hi), which carry x to 2^-17,
//   as the forward's PV does; rounded once a weight is off by up to 2^-8.
//   The split doubles three of the five products: 20 D FLOPs executed per
//   live pair in all.
// - Registers decide the tiles.  At DP = 128 a warp's dK and dV sums take
//   128 f32 registers a thread of the 255 a thread may hold, S^T and dP^T
//   over 32 queries 32 more, P and dS as hi + lo fragments 32; the products
//   run one 8-feature n-tile at a time (four sums in flight): 254 registers,
//   no spills.  The dQ kernel keeps Q's fragments (32) and its dQ sums (64)
//   and reads dO's fragments per tile.  The ring stages and rows computed at
//   a time are in Shape; python -m repro_torch.kernels.flash_bwd_variants
//   times the alternatives side by side.  Rows are padded by 16 bytes so
//   ldmatrix reads hit distinct banks; D is padded with zeros to DP in
//   {64, 128}.
// - A pre-scan lists the tiles in which some pair of the block can be live
//   (dK/dV: also the query tiles holding a row with no live key, whose dO / Sk
//   reaches every key); the sweep visits only those.  The masks are applied
//   to the fragments from the staged positions, skipped where the warp sees
//   only live pairs.  Early key blocks (dK/dV) and late query blocks (dQ) see
//   the most pairs under a causal mask and launch first.
// - The tensor cores' f32 sums are not rounded to nearest: dK and dV kept in
//   their accumulators over a whole sweep (49,152 rows for qwen2-1.5b's early
//   keys at S = 8192) read 1.29 of the gradient check's limit, the error on
//   the keys with the longest sums.  So each tile's contribution is summed
//   from zero on the tensor cores and then added to the running f32 sums
//   with a round-to-nearest add.
// - Each output element is summed by one thread in a fixed order: every run
//   gives the same bits.  The kv head of query head h is h / G and the layout
//   comes in as strides: no copy, no reduction pass.
#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // a block's own rows: keys (dK/dV) or queries (dQ), 16 per warp
constexpr int kChunk = 512;         // tile entries listed per pre-scan
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

// Head-width bucket DP: the sweep's tiles (kBQ queries a ring stage for
// dK/dV; kBK keys for dQ, computed kSubK at a time: the registers' limit),
// the shared row stride and the two kernels' shared memory in bytes.
template <int DP>
struct Shape {
  static constexpr int kBQ = DP == 128 ? 32 : 64;
  static constexpr int kBK = DP == 128 ? 32 : 64;
  static constexpr int kSubK = DP == 128 ? 32 : 64;
  static constexpr int kStride = DP + 8;  // bf16 per shared row: +16 bytes against bank conflicts
  static constexpr int kChunks = DP / 8;  // 16-byte copies per row
  static constexpr int kOwn = kRows * kStride;
  // dK/dV: K, V; two stages of Q and dO; lse and D; qpos, kpos, the list
  static constexpr size_t kBytesDkdv = sizeof(bf16) * (2 * (size_t)kOwn + 4 * (size_t)kBQ * kStride) +
                                       sizeof(float) * 4 * kBQ + sizeof(int) * (2 * kBQ + kRows + kChunk + 1);
  // dQ: Q, dO; two stages of K and V; kpos, the list, the block's query range
  static constexpr size_t kBytesDq = sizeof(bf16) * (2 * (size_t)kOwn + 4 * (size_t)kBK * kStride) +
                                     sizeof(int) * (2 * kBK + kChunk + 2 * kWarps + 1);
  static_assert(DP % 16 == 0 && kBQ % 16 == 0 && kBQ <= 64 && kSubK % 16 == 0 && kSubK <= 64 &&
                kBK % kSubK == 0 && kBK <= kThreads, "tile shape");
  static_assert(kBytesDkdv <= 232448 && kBytesDq <= 232448, "shared memory");
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

// Two 8 x 8 b16 matrices, transposed: rows from lanes 0-7 (r0) and 8-15 (r1).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr));
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

// d = a b for one m16n8k16 tile, from zero.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
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

// The A fragments (hi and lo terms) of a 16 x 16 k-step from two m16n8
// accumulator tiles: columns 0-7 in x0, 8-15 in x1.
__device__ __forceinline__ void split_frag(const float (&x0)[4], const float (&x1)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(x0[0], x0[1], hi[0], lo[0]);
  split_bf16(x0[2], x0[3], hi[1], lo[1]);
  split_bf16(x1[0], x1[1], hi[2], lo[2]);
  split_bf16(x1[2], x1[3], hi[3], lo[3]);
}

__device__ __forceinline__ bool masked(int kp, int qp, const Geometry& g) {
  return kp < 0 || (g.causal && kp > qp) || (g.use_window && (long long)kp <= (long long)qp - g.window);
}

// ldmatrix addresses of a warp's lane: the A operand of rows [r0, r0 + 16)
// at k-step kk; the B operand (two n-tiles) of rows [r0, r0 + 16) read as n
// (row-major (n, k)); the B operand (one n-tile) of rows [r0, r0 + 16) read
// as k (row-major (k, n), transposed) for columns [8 n, 8 n + 8).
template <int kStride>
__device__ __forceinline__ uint32_t a_addr(const bf16* base, int r0, int kk, int lane) {
  return smem_u32(base + (r0 + (lane & 15)) * kStride + 16 * kk + ((lane >> 4) << 3));
}
template <int kStride>
__device__ __forceinline__ uint32_t bn_addr(const bf16* base, int r0, int kk, int lane) {
  return smem_u32(base + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kStride + 16 * kk + (((lane >> 3) & 1) << 3));
}
template <int kStride>
__device__ __forceinline__ uint32_t bk_addr(const bf16* base, int r0, int n, int lane) {
  return smem_u32(base + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kStride + 8 * n);
}

// For the two n-tiles of columns [16 dp, 16 dp + 16), one at a time: t = sum over the k-steps kk of
// (hi[kk] + lo[kk]) B_kk on the tensor cores, from zero (B by ldmatrix.trans of rows [r0 + 16 kk,
// r0 + 16 kk + 16) of base), then acc += t in f32 round-to-nearest.  The tensor cores' own f32 sums are not
// rounded to nearest and drift over thousands of k-steps, so a tile's sum joins the running sum this way.
// One n-tile at a time keeps four sums and two B registers in flight: the dK/dV kernel sits at 254 of a
// thread's 255 registers.
template <int kSteps, int kStride>
__device__ __forceinline__ void tile_product(float (&acc0)[4], float (&acc1)[4], const uint32_t (&hi)[kSteps][4],
                                             const uint32_t (&lo)[kSteps][4], const bf16* base, int r0, int dp,
                                             int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t b0, b1;
      ldsm_x2_trans(bk_addr<kStride>(base, r0 + 16 * kk, 2 * dp + h, lane), b0, b1);
      if (kk == 0)
        mma_bf16_first(t, hi[kk], b0, b1);
      else
        mma_bf16(t, hi[kk], b0, b1);
      mma_bf16(t, lo[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) (h ? acc1 : acc0)[e] = __fadd_rn((h ? acc1 : acc0)[e], t[e]);
  }
}

// Compact the flags list_s[0, n) in place to the entries e0 + i that are set,
// and return how many.  Call with the whole block after the flags are
// written and synchronised; ends synchronised.
__device__ __forceinline__ int compact(int* list_s, int n, int e0, int* count_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0) {  // an entry moves only to a lower or equal slot
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const bool live = base + lane < n && list_s[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) list_s[cnt + __popc(ballot & ((1u << lane) - 1))] = e0 + base + lane;
      cnt += __popc(ballot);
    }
    if (lane == 0) *count_s = cnt;
  }
  __syncthreads();
  return *count_s;
}

// D_r = sum_d dO_rd O_rd in f32, one warp a row, lanes over the features in
// a fixed order.  delta is (B, H, Sq) contiguous.
__global__ void __launch_bounds__(256)
flash_bwd_mma_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
                           Geometry g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int r = blockIdx.x * 8 + warp;
  if (r >= g.Sq) return;
  const bf16* orow = o + b * g.o.b + h * g.o.h + r * g.o.s;
  const bf16* drow = dout + b * g.dout.b + h * g.dout.h + r * g.dout.s;
  float acc = 0.f;
  for (int c = lane; c < g.D; c += 32)
    acc = __fmaf_rn(__bfloat162float(orow[c]), __bfloat162float(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[(size_t)bh * g.Sq + r] = acc;
}

// Block blk of the dK/dV grid: (batch, kv head) blk % BH, keys from (blk / BH) kRows.  Values that the sweep
// needs rarely (the block's key range, the warp's key positions) are read from shared memory where they are
// used, not held in registers through the sweep: the dK and dV sums take 128 of a thread's 255.
template <int DP>
__device__ __forceinline__ void dkdv_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                           const int* __restrict__ qpos, const int* __restrict__ kpos,
                                           const float* __restrict__ lse, const float* __restrict__ delta,
                                           bf16* __restrict__ dk, bf16* __restrict__ dv, const Geometry& g, int blk) {
  using S = Shape<DP>;
  constexpr int kBT = S::kBQ, kStride = S::kStride, kChunks = S::kChunks, kNT = DP / 8, kJ = kBT / 8;
  constexpr int kTile = kBT * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + S::kOwn;
  bf16* Qt = Vs + S::kOwn;    // 2 stages
  bf16* Dt = Qt + 2 * kTile;  // 2 stages
  float* lse_s = reinterpret_cast<float*>(Dt + 2 * kTile);  // 2 x kBT
  float* dl_s = lse_s + 2 * kBT;                             // 2 x kBT
  int* qpos_s = reinterpret_cast<int*>(dl_s + 2 * kBT);     // 2 x kBT
  int* kpos_s = qpos_s + 2 * kBT;                            // kRows
  int* list_s = kpos_s + kRows;                              // kChunk
  int* count_s = list_s + kChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, quad = lane & 3, grp = lane >> 2;
  const int b = (blk % g.BH) / g.KV, kvh = (blk % g.BH) % g.KV;  // (batch, kv head)
  {
    // K and V -> shared, zero past Sk and past D; keys past Sk are dead
    const int k0 = (blk / g.BH) * kRows, n_keys = min(kRows, g.Sk - k0);
    const bf16* kh = k + b * g.k.b + kvh * g.k.h;
    const bf16* vh = v + b * g.v.b + kvh * g.v.h;
    for (int t = tid; t < kRows * kChunks; t += kThreads) {
      const int r = t / kChunks, c = t % kChunks;
      const bool ok = r < n_keys && c * 8 < g.D;
      const long long key = k0 + r;
      cp_async16(smem_u32(Ks + r * kStride + c * 8), ok ? kh + key * g.k.s + c * 8 : kh, ok);
      cp_async16(smem_u32(Vs + r * kStride + c * 8), ok ? vh + key * g.v.s + c * 8 : vh, ok);
    }
    cp_async_commit();
    if (tid < kRows) kpos_s[tid] = tid < n_keys ? kpos[(size_t)b * g.Sk + k0 + tid] : -1;
    __syncthreads();
  }

  // tile entries e = gi * n_qt + t: query head kvh * G + gi, rows [t kBT, (t + 1) kBT)
  const int n_qt = (g.Sq + kBT - 1) / kBT;
  // List the entries [e0, e0 + kChunk) holding a row that is live with some key of the block, or that has
  // no live key at all (lse = +inf); return how many.  Four entries per warp in flight.
  auto scan = [&](int e0) -> int {
    const int ka = kpos_s[lane], kb = kpos_s[lane + 32];  // the block's live keys' position range
    const int pmin = __reduce_min_sync(0xffffffffu, min(ka >= 0 ? ka : INT_MAX, kb >= 0 ? kb : INT_MAX));
    const int pmax = __reduce_max_sync(0xffffffffu, max(ka, kb));  // < 0: no live key
    const int* qp = qpos + (size_t)b * g.Sq;
    const int n = min(kChunk, g.G * n_qt - e0);
    for (int base = 0; base < n; base += 4 * kWarps) {
      bool any[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kWarps + warp;
        any[u] = false;
        if (i < n) {
          const int e = e0 + i, gi = e / n_qt, t = e - gi * n_qt;
          const float* lrow = lse + ((size_t)b * g.H + kvh * g.G + gi) * g.Sq;
#pragma unroll
          for (int half = 0; half < (kBT + 31) / 32; ++half) {
            const int r = t * kBT + 32 * half + lane;
            if (32 * half + lane < kBT && r < g.Sq) {
              const int p = qp[r];
              any[u] |= isinf(lrow[r]) || (pmax >= 0 && (!g.causal || pmin <= p) &&
                                           (!g.use_window || (long long)pmax > (long long)p - g.window));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kWarps + warp;
        const bool a = __any_sync(0xffffffffu, any[u]);
        if (lane == 0 && i < n) list_s[i] = a;
      }
    }
    __syncthreads();
    return compact(list_s, n, e0, count_s);
  };

  auto issue = [&](int e, int buf) {
    const int gi = e / n_qt, t0 = (e - gi * n_qt) * kBT, h = kvh * g.G + gi;
    const bf16* qh = q + b * g.q.b + h * g.q.h;
    const bf16* dh = dout + b * g.dout.b + h * g.dout.h;
    bf16* qd = Qt + buf * kTile;
    bf16* dd = Dt + buf * kTile;
#pragma unroll
    for (int t = tid; t < kBT * kChunks; t += kThreads) {
      const int r = t / kChunks, c = t % kChunks;
      const bool ok = t0 + r < g.Sq && c * 8 < g.D;
      const long long row = t0 + r;
      cp_async16(smem_u32(qd + r * kStride + c * 8), ok ? qh + row * g.q.s + c * 8 : qh, ok);
      cp_async16(smem_u32(dd + r * kStride + c * 8), ok ? dh + row * g.dout.s + c * 8 : dh, ok);
    }
    if (tid < kBT) {
      const int r = t0 + tid, at = buf * kBT + tid;
      const size_t row = ((size_t)b * g.H + h) * g.Sq + r;
      if (r < g.Sq) {
        cp_async4(smem_u32(qpos_s + at), qpos + (size_t)b * g.Sq + r);
        cp_async4(smem_u32(lse_s + at), lse + row);
        cp_async4(smem_u32(dl_s + at), delta + row);
      } else {  // rows past Sq: zero Q and dO make their terms 0
        qpos_s[at] = -1;
        lse_s[at] = 0.f;
        dl_s[at] = 0.f;
      }
    }
    cp_async_commit();
  };

  float dva[kNT][4], dka[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;

  int n_live = scan(0);
  for (int e0 = 0;;) {
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
      const bf16* qt = Qt + buf * kTile;
      const bf16* dt = Dt + buf * kTile;
      const int* qps = qpos_s + buf * kBT;
      const float* ls = lse_s + buf * kBT;
      const float* dls = dl_s + buf * kBT;

      // is every (key, query) pair of this warp and tile live?  Then no mask is needed.
      const int wk = kpos_s[warp * 16 + (lane & 15)];
      const int qa = qps[lane % kBT], qb = kBT > 32 ? qps[32 + lane % 32] : qa;
      const int wkmin = __reduce_min_sync(0xffffffffu, wk), wkmax = __reduce_max_sync(0xffffffffu, wk);
      const int tqmin = __reduce_min_sync(0xffffffffu, min(qa, qb));
      const int tqmax = __reduce_max_sync(0xffffffffu, max(qa, qb));
      const bool full = wkmin >= 0 && (!g.causal || wkmax <= tqmin) &&
                        (!g.use_window || (long long)wkmin > (long long)tqmax - g.window);
      const float sl = g.scale * kLog2e;  // scores in the log2 domain

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys (rows) x kBT queries (kJ n-tiles)
      float st[kJ][4], dpt[kJ][4];
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t kf[4], vf[4];
        ldsm_x4(a_addr<kStride>(Ks, warp * 16, kk, lane), kf);
        ldsm_x4(a_addr<kStride>(Vs, warp * 16, kk, lane), vf);
#pragma unroll
        for (int jp = 0; jp < kBT / 16; ++jp) {
          uint32_t bq[4], bd[4];
          ldsm_x4(bn_addr<kStride>(qt, 16 * jp, kk, lane), bq);
          mma_bf16(st[2 * jp], kf, bq[0], bq[1]);
          mma_bf16(st[2 * jp + 1], kf, bq[2], bq[3]);
          ldsm_x4(bn_addr<kStride>(dt, 16 * jp, kk, lane), bd);
          mma_bf16(dpt[2 * jp], vf, bd[0], bd[1]);
          mma_bf16(dpt[2 * jp + 1], vf, bd[2], bd[3]);
        }
      }
      // P^T into st, dS^T into dpt; element (j, e) is key grp + 8 (e >> 1), query 8 j + 2 quad + (e & 1)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = 8 * j + 2 * quad;
        const float2 L = *reinterpret_cast<const float2*>(ls + c);
        const float2 dl = *reinterpret_cast<const float2*>(dls + c);
        const float l2[2] = {L.x * kLog2e, L.y * kLog2e}, d[2] = {dl.x, dl.y};
        if (full) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = ex2(__fmaf_rn(st[j][e], sl, -l2[e & 1]));
            dpt[j][e] = st[j][e] * (dpt[j][e] - d[e & 1]);
          }
        } else {
          const int2 qv = *reinterpret_cast<const int2*>(qps + c);
          const int qq[2] = {qv.x, qv.y}, kp[2] = {kpos_s[warp * 16 + grp], kpos_s[warp * 16 + grp + 8]};
          // a masked pair weighs 0, or 1 / Sk in dV on a row with no live key (all its pairs are masked)
          const float inv_sk = 1.f / static_cast<float>(g.Sk);
          const float pm[2] = {isinf(L.x) ? inv_sk : 0.f, isinf(L.y) ? inv_sk : 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool m = masked(kp[e >> 1], qq[e & 1], g);
            const float p = m ? pm[e & 1] : ex2(__fmaf_rn(st[j][e], sl, -l2[e & 1]));
            dpt[j][e] = m ? 0.f : p * (dpt[j][e] - d[e & 1]);
            st[j][e] = p;
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q over the tile's queries, each weight as hi + lo bf16 terms, every
      // 8-feature slice summed from zero on the tensor cores (16 queries a k-step), then added to the running
      // sums
      uint32_t ph[kBT / 16][4], pl[kBT / 16][4], sh[kBT / 16][4], slo[kBT / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBT / 16; ++kk) {
        split_frag(st[2 * kk], st[2 * kk + 1], ph[kk], pl[kk]);
        split_frag(dpt[2 * kk], dpt[2 * kk + 1], sh[kk], slo[kk]);
      }
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        tile_product<kBT / 16, kStride>(dva[2 * dp], dva[2 * dp + 1], ph, pl, dt, 0, dp, lane);
        tile_product<kBT / 16, kStride>(dka[2 * dp], dka[2 * dp + 1], sh, slo, qt, 0, dp, lane);
      }
      __syncthreads();  // this stage is refilled two entries on
    }
    e0 += kChunk;
    if (e0 >= g.G * n_qt) break;
    n_live = scan(e0);
  }
  cp_async_wait<0>();  // K and V, where no entry was visited

  // rows r0 and r1 = r0 + 8 of the warp's keys, columns 8 n + 2 quad (+1); dK times 1/sqrt(D)
  const int k0 = (blk / g.BH) * kRows, n_keys = min(kRows, g.Sk - k0);
  const int r0 = warp * 16 + grp, r1 = r0 + 8;
  const long long key0 = k0 + r0, key1 = k0 + r1;
  bf16* dk0 = dk + b * g.dk.b + kvh * g.dk.h + key0 * g.dk.s;
  bf16* dk1 = dk + b * g.dk.b + kvh * g.dk.h + key1 * g.dk.s;
  bf16* dv0 = dv + b * g.dv.b + kvh * g.dv.h + key0 * g.dv.s;
  bf16* dv1 = dv + b * g.dv.b + kvh * g.dv.h + key1 * g.dv.s;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int c = 8 * n + 2 * quad;
    if (8 * n >= g.D) break;
    if (r0 < n_keys) {
      *reinterpret_cast<uint32_t*>(dk0 + c) = pack_bf16(dka[n][0] * g.scale, dka[n][1] * g.scale);
      *reinterpret_cast<uint32_t*>(dv0 + c) = pack_bf16(dva[n][0], dva[n][1]);
    }
    if (r1 < n_keys) {
      *reinterpret_cast<uint32_t*>(dk1 + c) = pack_bf16(dka[n][2] * g.scale, dka[n][3] * g.scale);
      *reinterpret_cast<uint32_t*>(dv1 + c) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// Block blk of the dQ grid: (batch, query head) blk % BH, query rows from the late end.
template <int DP>
__device__ __forceinline__ void dq_block(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                         const int* __restrict__ qpos, const int* __restrict__ kpos,
                                         const float* __restrict__ lse, const float* __restrict__ delta,
                                         bf16* __restrict__ dq, const Geometry& g, int blk) {
  using S = Shape<DP>;
  constexpr int kBT = S::kBK, kSub = S::kSubK, kStride = S::kStride, kChunks = S::kChunks, kNT = DP / 8;
  constexpr int kJ = kSub / 8, kTile = kBT * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + S::kOwn;
  bf16* Kt = Ds + S::kOwn;    // 2 stages
  bf16* Vt = Kt + 2 * kTile;  // 2 stages
  int* kpos_s = reinterpret_cast<int*>(Vt + 2 * kTile);  // 2 x kBT
  int* list_s = kpos_s + 2 * kBT;                            // kChunk
  int* red_s = list_s + kChunk;                              // 2 x kWarps
  int* count_s = red_s + 2 * kWarps;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, quad = lane & 3, grp = lane >> 2;
  const int bh = blk % g.BH;                              // (batch, query head)
  const int q0 = (g.n_blocks - 1 - blk / g.BH) * kRows;  // late query blocks see the most keys: first
  const int b = bh / g.H, h = bh - b * g.H, kvh = h / g.G;
  const bf16* qh = q + b * g.q.b + h * g.q.h;
  const bf16* dh = dout + b * g.dout.b + h * g.dout.h;
  const bf16* kh = k + b * g.k.b + kvh * g.k.h;
  const bf16* vh = v + b * g.v.b + kvh * g.v.h;
  const int* qp = qpos + (size_t)b * g.Sq;
  const int* kp = kpos + (size_t)b * g.Sk;
  const int rows = min(kRows, g.Sq - q0);

  // Q and dO -> shared, zero past Sq and past D
  for (int t = tid; t < kRows * kChunks; t += kThreads) {
    const int r = t / kChunks, c = t % kChunks;
    const bool ok = r < rows && c * 8 < g.D;
    const long long row = q0 + r;
    cp_async16(smem_u32(Qs + r * kStride + c * 8), ok ? qh + row * g.q.s + c * 8 : qh, ok);
    cp_async16(smem_u32(Ds + r * kStride + c * 8), ok ? dh + row * g.dout.s + c * 8 : dh, ok);
  }
  cp_async_commit();

  // this thread's rows r0 and r1 = r0 + 8: positions, lse (log2 domain; +inf past Sq) and D; the
  // position ranges of the warp's and the block's rows
  const int r0 = warp * 16 + grp, r1 = r0 + 8;
  const size_t row0 = (size_t)bh * g.Sq + q0;
  const int qp0 = r0 < rows ? qp[q0 + r0] : 0, qp1 = r1 < rows ? qp[q0 + r1] : 0;
  const float l20 = r0 < rows ? lse[row0 + r0] * kLog2e : INFINITY;
  const float l21 = r1 < rows ? lse[row0 + r1] * kLog2e : INFINITY;
  const float d0 = r0 < rows ? delta[row0 + r0] : 0.f, d1 = r1 < rows ? delta[row0 + r1] : 0.f;
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

  // List the key tiles [c0, c0 + kChunk) in which some pair of the block can be live; return how many.
  const int n_tiles = (g.Sk + kBT - 1) / kBT;
  auto scan = [&](int c0) -> int {
    const int n = min(kChunk, n_tiles - c0);
    for (int t = warp; t < n; t += kWarps) {
      bool any = false;
#pragma unroll
      for (int half = 0; half < (kBT + 31) / 32; ++half) {
        const int key = (c0 + t) * kBT + 32 * half + lane;
        const int kv = 32 * half + lane < kBT && key < g.Sk ? kp[key] : -1;
        any |= kv >= 0 && (!g.causal || kv <= qmax) && (!g.use_window || (long long)kv > (long long)qmin - g.window);
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) list_s[t] = any;
    }
    __syncthreads();
    return compact(list_s, n, c0, count_s);
  };
  int n_live = scan(0);

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];  // A fragments of the warp's 16 rows of Q (dO's are read per tile: registers)
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(a_addr<kStride>(Qs, warp * 16, kk, lane), qf[kk]);

  auto issue = [&](int tile, int buf) {
    const int t0 = tile * kBT;
    bf16* kd = Kt + buf * kTile;
    bf16* vd = Vt + buf * kTile;
#pragma unroll
    for (int t = tid; t < kBT * kChunks; t += kThreads) {
      const int r = t / kChunks, c = t % kChunks;
      const bool ok = t0 + r < g.Sk && c * 8 < g.D;
      const long long key = t0 + r;
      cp_async16(smem_u32(kd + r * kStride + c * 8), ok ? kh + key * g.k.s + c * 8 : kh, ok);
      cp_async16(smem_u32(vd + r * kStride + c * 8), ok ? vh + key * g.v.s + c * 8 : vh, ok);
    }
    if (tid < kBT) {
      int* dst = kpos_s + buf * kBT + tid;
      if (t0 + tid < g.Sk)
        cp_async4(smem_u32(dst), kp + t0 + tid);
      else
        *dst = -1;  // keys past Sk are dead
    }
    cp_async_commit();
  };

  float dqa[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const float sl = g.scale * kLog2e;

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
      const bf16* kt = Kt + buf * kTile;
      const bf16* vt = Vt + buf * kTile;
#pragma unroll 1
      for (int sub0 = 0; sub0 < kBT; sub0 += kSub) {  // the stage's keys, kSub at a time
        const int* kps = kpos_s + buf * kBT + sub0;

        // is every (row, key) pair of this warp and sub-tile live?  Then no mask is needed.
        const int ka = kps[lane % kSub], kb = kSub > 32 ? kps[32 + lane % 32] : ka;
        const int kmin = __reduce_min_sync(0xffffffffu, min(ka, kb));
        const int kmax = __reduce_max_sync(0xffffffffu, max(ka, kb));
        const bool full = kmin >= 0 && (!g.causal || kmax <= wqmin) &&
                          (!g.use_window || (long long)kmin > (long long)wqmax - g.window);

        // S = Q K^T and dP = dO V^T: rows r0 (x[j][0..1]) and r1 (x[j][2..3]), keys sub0 + 8 j + 2 quad (+1)
        float s[kJ][4], dp[kJ][4];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          uint32_t df[4];
          ldsm_x4(a_addr<kStride>(Ds, warp * 16, kk, lane), df);
#pragma unroll
          for (int jp = 0; jp < kSub / 16; ++jp) {
            uint32_t bk[4], bv[4];
            ldsm_x4(bn_addr<kStride>(kt, sub0 + 16 * jp, kk, lane), bk);
            mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
            ldsm_x4(bn_addr<kStride>(vt, sub0 + 16 * jp, kk, lane), bv);
            mma_bf16(dp[2 * jp], df, bv[0], bv[1]);
            mma_bf16(dp[2 * jp + 1], df, bv[2], bv[3]);
          }
        }

        // dS into s
        const float l2[2] = {l20, l21}, d[2] = {d0, d1};
        const int qq[2] = {qp0, qp1};
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          if (full) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = ex2(__fmaf_rn(s[j][e], sl, -l2[e >> 1])) * (dp[j][e] - d[e >> 1]);
          } else {
            const int2 kv = *reinterpret_cast<const int2*>(kps + 8 * j + 2 * quad);
            const int kk2[2] = {kv.x, kv.y};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = masked(kk2[e & 1], qq[e >> 1], g)
                            ? 0.f
                            : ex2(__fmaf_rn(s[j][e], sl, -l2[e >> 1])) * (dp[j][e] - d[e >> 1]);
          }
        }

        // dQ += dS K over the sub-tile's keys, dS as hi + lo bf16 terms; every 16-feature slice summed from
        // zero on the tensor cores (16 keys a k-step), then added to the running sums
        uint32_t sh[kSub / 16][4], slo[kSub / 16][4];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) split_frag(s[2 * kk], s[2 * kk + 1], sh[kk], slo[kk]);
#pragma unroll
        for (int dpi = 0; dpi < DP / 16; ++dpi)
          tile_product<kSub / 16, kStride>(dqa[2 * dpi], dqa[2 * dpi + 1], sh, slo, kt, sub0, dpi, lane);
      }
      __syncthreads();  // this stage is refilled two tiles on
    }
    c0 += kChunk;
    if (c0 >= n_tiles) break;
    n_live = scan(c0);
  }

  bf16* out0 = dq + b * g.dq.b + h * g.dq.h + (long long)(q0 + r0) * g.dq.s;
  bf16* out1 = dq + b * g.dq.b + h * g.dq.h + (long long)(q0 + r1) * g.dq.s;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int c = 8 * n + 2 * quad;
    if (8 * n >= g.D) break;
    if (r0 < rows) *reinterpret_cast<uint32_t*>(out0 + c) = pack_bf16(dqa[n][0] * g.scale, dqa[n][1] * g.scale);
    if (r1 < rows) *reinterpret_cast<uint32_t*>(out1 + c) = pack_bf16(dqa[n][2] * g.scale, dqa[n][3] * g.scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_mma_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
                          const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, Geometry g) {
  dkdv_block<DP>(q, k, v, dout, qpos, kpos, lse, delta, dk, dv, g, static_cast<int>(blockIdx.x));
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_mma_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const int* __restrict__ qpos, const int* __restrict__ kpos,
                        const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                        Geometry g) {
  dq_block<DP>(q, k, v, dout, qpos, kpos, lse, delta, dq, g, static_cast<int>(blockIdx.x));
}

// A second stream and two events per device, made at first use: the dQ kernel runs on it beside the dK/dV
// kernel, fenced by the events on both sides, so the caller's stream orders the whole backward.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t ready = nullptr, done = nullptr;
};
constexpr int kMaxDevices = 64;
std::mutex side_mu;  // guards sides and the enqueue sequence that records and waits on their events
Side sides[kMaxDevices];

cudaError_t side_of(Side** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    if ((e = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)) != cudaSuccess) return e;
    if ((e = cudaEventCreateWithFlags(&s.ready, cudaEventDisableTiming)) != cudaSuccess) return e;
    if ((e = cudaEventCreateWithFlags(&s.done, cudaEventDisableTiming)) != cudaSuccess) return e;
  }
  *out = &s;
  return cudaSuccess;
}

template <int DP>
int run(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout, const int* qpos,
        const int* kpos, const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, Geometry g, int batch,
        cudaStream_t stream) {
  using S = Shape<DP>;
  Geometry gk = g, gq = g;
  gk.BH = batch * g.KV;
  gk.n_blocks = (g.Sk + kRows - 1) / kRows;
  gq.BH = batch * g.H;
  gq.n_blocks = (g.Sq + kRows - 1) / kRows;
  auto dkdv = flash_bwd_mma_dkdv_kernel<DP>;
  auto dqk = flash_bwd_mma_dq_kernel<DP>;
  cudaError_t e = repro::allow_smem(dkdv, S::kBytesDkdv);
  if (e == cudaSuccess) e = repro::allow_smem(dqk, S::kBytesDq);
  if (e != cudaSuccess) return static_cast<int>(e);

  std::lock_guard<std::mutex> lock(side_mu);
  Side* side = nullptr;
  if ((e = side_of(&side)) != cudaSuccess) return static_cast<int>(e);
  flash_bwd_mma_delta_kernel<<<dim3((g.Sq + 7) / 8, batch * g.H), 256, 0, stream>>>(o, dout, delta, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaEventRecord(side->ready, stream)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaStreamWaitEvent(side->stream, side->ready, 0)) != cudaSuccess) return static_cast<int>(e);
  dkdv<<<gk.n_blocks * gk.BH, kThreads, S::kBytesDkdv, stream>>>(q, k, v, dout, qpos, kpos, lse, delta, dk, dv, gk);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dqk<<<gq.n_blocks * gq.BH, kThreads, S::kBytesDq, side->stream>>>(q, k, v, dout, qpos, kpos, lse, delta, dq, gq);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaEventRecord(side->done, side->stream)) != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamWaitEvent(stream, side->done, 0));
}

}  // namespace

// The tensor-core route of repro_flash_attention_bwd, with the same
// arguments: q, o, dout and dq (B, H, Sq, D), k, v, dk and dv (B, KV, Sk, D)
// as strided bf16 views (dtype 1 only; element strides for batch, head and
// sequence, features contiguous); qpos (B, Sq) and kpos (B, Sk) contiguous
// int32; lse (B, H, Sq) contiguous f32 as the forward wrote it; delta a
// (B, H, Sq) f32 scratch.  H = KV * G, D <= 128 and a multiple of 8, every
// pointer 16-byte aligned and every stride a multiple of 8 elements (the
// caller checks those two: the 16-byte copies need them), B * H <= 65535.
// Ordered on `stream` (the dQ kernel runs on a second stream between events
// recorded and waited on there); returns the first CUDA error that is not
// cudaSuccess.
extern "C" int repro_flash_attention_bwd_mma(int dtype, const void* q, const void* k, const void* v, const void* o,
                                             const void* dout, const void* qpos, const void* kpos, const void* lse,
                                             void* delta, void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
                                             int Sk, int D, long long qsb, long long qsh, long long qss,
                                             long long ksb, long long ksh, long long kss, long long vsb,
                                             long long vsh, long long vss, long long osb, long long osh,
                                             long long oss, long long dosb, long long dosh, long long doss,
                                             long long dqsb, long long dqsh, long long dqss, long long dksb,
                                             long long dksh, long long dkss, long long dvsb, long long dvsh,
                                             long long dvss, int causal, int use_window, int window, float scale,
                                             void* stream) {
  const long long blocks = (Sq + (long long)kRows - 1) / kRows * B * H + (Sk + (long long)kRows - 1) / kRows * B * KV;
  if (dtype != 1 || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || (long long)B * H > 65535 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{H, KV, H / KV, Sq, Sk, D, 0, 0, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                   {osb, osh, oss}, {dosb, dosh, doss}, {dqsb, dqsh, dqss}, {dksb, dksh, dkss}, {dvsb, dvsh, dvss},
                   causal, use_window, window, scale};
  auto c = [](const void* p) { return static_cast<const bf16*>(p); };
  auto m = [](void* p) { return static_cast<bf16*>(p); };
  const auto* qp = static_cast<const int*>(qpos);
  const auto* kp = static_cast<const int*>(kpos);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return run<64>(c(q), c(k), c(v), c(o), c(dout), qp, kp, l, dl, m(dq), m(dk), m(dv), g, B, s);
  return run<128>(c(q), c(k), c(v), c(o), c(dout), qp, kp, l, dl, m(dq), m(dk), m(dv), g, B, s);
}
