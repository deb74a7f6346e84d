// The k-nearest core shared by the knn and Eq. 6 bubble core distance
// kernels (knn_ws.cu, bubble_cd_ws.cu), for Hopper's CUDA cores in IEEE f32.
//
// Distance tile in registers.  A warp owns R query rows whose coordinates
// sit in registers (or, where the queues leave no room, in shared memory,
// read by broadcast), zero-padded from d up to the template width
// D in {16, 32, 64, 128}; an FMA of two zeros leaves the accumulator's bits
// unchanged.  The y table streams through a double-buffered cp.async ring of
// shared-memory chunks, padded the same way, with each chunk's norms
// computed once.  Each lane takes the chunk's columns lane, lane + 32, ...,
// reads a y row once as 16-byte loads and feeds R·D FMAs with it.  The
// arithmetic is common.cuh's exactly (dot_chain's ascending __fmaf_rn chain,
// expanded_sq, a correctly rounded sqrtf), so every distance is bitwise the
// one the per-lane kernels (knn.cu, bubble_cd.cu) compute, and a row that
// is also in y is exactly 0 from itself.
//
// Selection in registers: WarpSelect (Johnson, Douze & Jegou, "Billion-scale
// similarity search with GPUs", 2017, section 4).  A candidate is the 64-bit
// key (bits of its distance, column): distances are >= +0, so the key order
// is the lexicographic (distance, index) order, and the result is exactly
// the first k entries of that global order, whatever order the merges run
// in.  Per row, each lane keeps an unsorted thread queue of T keys, and the
// warp a sorted queue of K = 32·Q >= k keys (element q·32 + lane in the
// lane's register q).  A candidate enters its thread queue only if it beats
// the row's k-th queued key; its root is taken only if its squared distance
// lies below a bound rounded up from that key's distance (sqrtf is correctly
// rounded, so no candidate that could enter is dropped), and one warp vote
// per step skips the offers when no lane's candidate is below it.  When any lane's
// thread queue is full, the warp sorts the 32·T thread-queue keys by a
// bitonic network of shuffles and merges them into the warp queue: the
// minimum against the reversed sorted keys, then bitonic half-cleaners.
// Every register array is indexed by compile-time values only.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace ws {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;         // the largest warp queue
constexpr int kChunkFloats = 8192;  // one buffer of the y ring (32 KB)

using Key = unsigned long long;
constexpr Key kEmpty = ~0ull;

__device__ __forceinline__ Key make_key(float dist, int j) {
  return (static_cast<Key>(__float_as_uint(dist)) << 32) | static_cast<unsigned>(j);
}
__device__ __forceinline__ float key_dist(Key k) { return __uint_as_float(static_cast<unsigned>(k >> 32)); }
__device__ __forceinline__ int key_index(Key k) { return static_cast<int>(static_cast<unsigned>(k)); }
__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }
__device__ __forceinline__ Key kmax(Key a, Key b) { return a < b ? b : a; }

// The smaller (keep_min) or larger of this lane's key and lane ^ s's.
__device__ __forceinline__ Key exchange(Key v, int s, bool keep_min) {
  const Key o = __shfl_xor_sync(kFull, v, s);
  return keep_min == (o < v) ? o : v;
}

// Stages S, S/2, ..., 1 of a bitonic network over the 32·N keys a[t]
// (element t·32 + lane): element e pairs with e ^ s, and the run of BLOCK
// elements holding e ascends when e & BLOCK == 0 (BLOCK = 32·N: every run
// ascends, a final merge).
template <int N, int BLOCK, int S>
__device__ __forceinline__ void bitonic_stages(Key (&a)[N], int lane) {
  if constexpr (S >= 32) {
    constexpr int sr = S / 32;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if ((t & sr) == 0) {
        const bool asc = ((t * 32) & BLOCK) == 0;
        const Key lo = kmin(a[t], a[t | sr]), hi = kmax(a[t], a[t | sr]);
        a[t] = asc ? lo : hi;
        a[t | sr] = asc ? hi : lo;
      }
    }
  } else {
    const bool lower = (lane & S) == 0;
#pragma unroll
    for (int t = 0; t < N; ++t) a[t] = exchange(a[t], S, lower == ((((t * 32) | lane) & BLOCK) == 0));
  }
  if constexpr (S > 1) bitonic_stages<N, BLOCK, S / 2>(a, lane);
}

// Sort the 32·N keys ascending, from runs of BLOCK / 2 on.
template <int N, int BLOCK = 2>
__device__ __forceinline__ void bitonic_sort(Key (&a)[N], int lane) {
  bitonic_stages<N, BLOCK, BLOCK / 2>(a, lane);
  if constexpr (BLOCK < 32 * N) bitonic_sort<N, BLOCK * 2>(a, lane);
}

// w[q] for a warp-uniform q, by a tree of selects on q's bits (an index
// into a register array would put the array in local memory).
template <int N>
__device__ __forceinline__ Key pick(const Key (&w)[N], int q) {
  if constexpr (N == 1) {
    return w[0];
  } else {
    Key h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) h[i] = (q & 1) ? w[2 * i + 1] : w[2 * i];
    return pick<N / 2>(h, q >> 1);
  }
}

// One row's selection state: K = 32·Q keys of warp queue, T of thread queue.
template <int K, int T>
struct WarpSelect {
  static constexpr int Q = K / 32;
  Key w[Q];    // warp queue, ascending: element q·32 + lane
  Key tq[T];   // this lane's thread queue, unsorted
  int nv;      // keys in tq
  Key kth;     // the k-th queued key; kEmpty until k are queued
  float thr2;  // NaN until then; else above every sq whose root could enter

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < Q; ++q) w[q] = kEmpty;
#pragma unroll
    for (int t = 0; t < T; ++t) tq[t] = kEmpty;
    nv = 0;
    kth = kEmpty;
    thr2 = __int_as_float(0x7fffffff);
  }

  // Column j at squared distance sq (valid: j is a real column).
  __device__ __forceinline__ void offer(float sq, int j, bool valid) {
    if (valid && !(sq >= thr2)) {
      const Key key = make_key(sqrtf(sq), j);
      if (key < kth) {
#pragma unroll
        for (int t = T - 1; t > 0; --t) tq[t] = tq[t - 1];
        tq[0] = key;
        ++nv;
      }
    }
  }

  // A ready-made key (valid: the candidate counts).  For callers that
  // select over stored distances (csrc/dynamic.cu); offer above is untouched.
  __device__ __forceinline__ void offer_key(Key key, bool valid) {
    if (valid && key < kth) {
#pragma unroll
      for (int t = T - 1; t > 0; --t) tq[t] = tq[t - 1];
      tq[0] = key;
      ++nv;
    }
  }

  // Merge the thread queues into the warp queue when any lane asks.
  __device__ __forceinline__ void merge_if(bool mine, int lane, int k) {
    if (__any_sync(kFull, mine)) merge(lane, k);
  }

  __device__ __forceinline__ void merge(int lane, int k) {
    bitonic_sort<T>(tq, lane);
    // the K smallest of both, as a bitonic sequence: w[i] = min(w[i], tq[K-1-i]),
    // where element K-1-i of tq is register Q-1-q of lane 31 - lane
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (Q - 1 - q < T) w[q] = kmin(w[q], __shfl_xor_sync(kFull, tq[Q - 1 - q < T ? Q - 1 - q : 0], 31));
    }
    bitonic_stages<Q, K, K / 2>(w, lane);
#pragma unroll
    for (int t = 0; t < T; ++t) tq[t] = kEmpty;
    nv = 0;
    kth = __shfl_sync(kFull, pick(w, (k - 1) >> 5), (k - 1) & 31);
    if (kth != kEmpty) {
      // sqrtf(sq) <= thr implies sq < next(thr)^2, rounded up here
      const float up = nextafterf(key_dist(kth), __int_as_float(0x7f800000));
      thr2 = __fmul_ru(up, up);
    }
  }
};

// Launch shape per (D, K) and kernel (SELF: bubble_cd).  T: thread-queue
// length.  R: rows per warp (4 at D = 16, 2 at D = 32, fewer where the
// queues grow).  XREG: the rows' coordinates fit in registers beside the
// queues.  Warps per block, the blocks per SM the registers must allow and
// the columns a lane takes per step are 8, 1 and 1, except on the main
// path's shapes (k = 10 and min_pts = 10 at D = 16), where latency, not
// shared memory, bounds the loop: knn at K = 32 takes blocks of 4 warps,
// three per SM, two columns per step; bubble_cd at K <= 64 takes R halved,
// two blocks per SM and two columns per step, since its 8192 rows fill the
// card only with more warps in flight (chosen by timing variants on the
// H100; PERF.md).
constexpr int rows_for(int d, int q, int t, int r) {
  return (r > 1 && r * (d + 2 * (q + t)) > 128) ? rows_for(d, q, t, r / 2) : r;
}

template <int D, int K, bool SELF>
struct Config {
  static constexpr bool kSmall = D <= 32 && (SELF ? K <= 64 : K == 32);
  static constexpr int Q = K / 32;
  static constexpr int T = K <= 64 ? 2 : (K <= 256 ? 4 : 8);
  static constexpr int kRowBase = (kSmall && SELF) ? 32 : 64;
  static constexpr int R = rows_for(D, Q, T, D >= kRowBase ? 1 : kRowBase / D);
  static constexpr bool XREG = R * (D + 2 * (Q + T)) <= 160;
  static constexpr int kWarps = (kSmall && !SELF) ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = kSmall ? (SELF ? 2 : 3) : 1;
  static constexpr int kCols = kSmall ? 2 : 1;
};

// The y ring: two buffers of CH staged rows (stride SD: 16-byte loads of
// consecutive rows hit distinct banks) and their norms.
template <int D>
struct Ring {
  static constexpr int SD = D + 4;
  static constexpr int CH = ((kChunkFloats / (SD + 1)) & ~63) > 64 ? ((kChunkFloats / (SD + 1)) & ~63) : 64;
  static constexpr size_t kFloats = 2 * (size_t)CH * (SD + 1);
};

template <typename C, int D>
__host__ inline size_t smem_bytes() {
  return sizeof(float) * (Ring<D>::kFloats + (C::XREG ? 0 : (size_t)C::kWarps * C::R * Ring<D>::SD));
}

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;

// Start the copies of y rows [c0, c0 + CH) into `rows` (zero past m and d);
// vec4: d % 4 == 0 and y 16-byte aligned.
template <int D, int kThreads, int CH = Ring<D>::CH>
__device__ __forceinline__ void stage_chunk(float* rows, const float* __restrict__ y, int c0, int m, int d,
                                            bool vec4) {
  constexpr int SD = Ring<D>::SD;
  if (vec4) {
    constexpr int G = D / 4;
    for (int t = threadIdx.x; t < CH * G; t += kThreads) {
      const int r = t / G, f = (t % G) * 4;
      const bool ok = c0 + r < m && f < d;
      cp_async16(rows + r * SD + f, ok ? y + (size_t)(c0 + r) * d + f : y, ok);
    }
  } else {
    for (int t = threadIdx.x; t < CH * D; t += kThreads) {
      const int r = t / D, f = t % D;
      const bool ok = c0 + r < m && f < d;
      cp_async4(rows + r * SD + f, ok ? y + (size_t)(c0 + r) * d + f : y, ok);
    }
  }
  cp_async_commit();
}

// Norms of the staged rows: dot_chain over the padded width, the same bits.
template <int D, int kThreads>
__device__ __forceinline__ void chunk_norms(const float* rows, float* norms) {
  constexpr int SD = Ring<D>::SD, CH = Ring<D>::CH;
  for (int j = threadIdx.x; j < CH; j += kThreads) {
    const float4* p = reinterpret_cast<const float4*>(rows + j * SD);
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < D / 4; ++g) {
      const float4 v = p[g];
      acc = __fmaf_rn(v.x, v.x, acc);
      acc = __fmaf_rn(v.y, v.y, acc);
      acc = __fmaf_rn(v.z, v.z, acc);
      acc = __fmaf_rn(v.w, v.w, acc);
    }
    norms[j] = acc;
  }
}

// Every row of this warp (rows row0 .. row0 + R - 1 of x, n rows) against
// all m rows of y, into sel: on return each sel[r].w holds the row's K
// smallest (distance, column) keys, ascending.  SELF: x is y, and the pair
// (row, row) is exactly 0.  Call with the whole block; smem holds
// smem_bytes<C, D>().
template <typename C, int D, bool SELF>
__device__ __forceinline__ void select_rows(WarpSelect<C::Q * 32, C::T> (&sel)[C::R], const float* __restrict__ x,
                                            int n, const float* __restrict__ y, int m, int d, int k, bool vec4,
                                            int row0, float* smem) {
  constexpr int R = C::R, T = C::T, COLS = C::kCols, NT = C::kThreads;
  constexpr bool XREG = C::XREG;
  constexpr int SD = Ring<D>::SD, CH = Ring<D>::CH;
  const int lane = threadIdx.x & 31;
  float* rows_buf = smem;                // 2 x CH x SD
  float* norm_buf = smem + 2 * CH * SD;  // 2 x CH
  float* xs = norm_buf + 2 * CH + (threadIdx.x >> 5) * R * SD;  // !XREG: this warp's rows

  stage_chunk<D, NT>(rows_buf, y, 0, m, d, vec4);

  float xr[XREG ? R : 1][D];
  float xx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if constexpr (XREG) {
#pragma unroll
      for (int f = 0; f < D; ++f) xr[r][f] = (i < n && f < d) ? x[(size_t)i * d + f] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) acc = __fmaf_rn(xr[r][f], xr[r][f], acc);
      xx[r] = acc;
    } else {
      for (int f = lane; f < D; f += 32) xs[r * SD + f] = (i < n && f < d) ? x[(size_t)i * d + f] : 0.f;
      __syncwarp();
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < D; ++f) acc = __fmaf_rn(xs[r * SD + f], xs[r * SD + f], acc);
      xx[r] = acc;
    }
    sel[r].init();
  }

  cp_async_wait_all();
  __syncthreads();
  chunk_norms<D, NT>(rows_buf, norm_buf);
  __syncthreads();

  const int nchunks = (m + CH - 1) / CH;
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    if (c + 1 < nchunks) stage_chunk<D, NT>(rows_buf + (b ^ 1) * CH * SD, y, (c + 1) * CH, m, d, vec4);
    const int c0 = c * CH, cn = min(CH, m - c0);
    // this lane's first column of the chunk; columns past cn (< CH, a
    // multiple of 64) are staged zeros
    const float4* yp = reinterpret_cast<const float4*>(rows_buf + b * CH * SD + lane * SD);
    const float* np = norm_buf + b * CH + lane;
    for (int j0 = 0; j0 < cn; j0 += 32 * COLS, yp += 32 * COLS * (SD / 4), np += 32 * COLS) {
      // t = (|x|^2 + |y|^2) - 2 x.y; expanded_sq is max(t, 0)
      float t[COLS][R];
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
        for (int g = 0; g < D / 4; ++g) {
          const float4 v = yp[u * 32 * (SD / 4) + g];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float4 xv;
            if constexpr (XREG) {
              xv = make_float4(xr[r][4 * g], xr[r][4 * g + 1], xr[r][4 * g + 2], xr[r][4 * g + 3]);
            } else {
              xv = reinterpret_cast<const float4*>(xs + r * SD)[g];
            }
            acc[r] = __fmaf_rn(xv.x, v.x, acc[r]);
            acc[r] = __fmaf_rn(xv.y, v.y, acc[r]);
            acc[r] = __fmaf_rn(xv.z, v.z, acc[r]);
            acc[r] = __fmaf_rn(xv.w, v.w, acc[r]);
          }
        }
        const float yn = np[32 * u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          t[u][r] = __fsub_rn(__fadd_rn(xx[r], yn), __fmul_rn(2.f, acc[r]));
          if (SELF && c0 + j0 + 32 * u + lane == row0 + r) t[u][r] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int j = j0 + 32 * u + lane;
        const bool valid = j < cn;
        // max(t, 0) < thr2 exactly when t < thr2: thr2 > 0, or NaN (no bound yet)
        bool pass = false;
#pragma unroll
        for (int r = 0; r < R; ++r) pass |= valid && !(t[u][r] >= sel[r].thr2);
        if (__any_sync(kFull, pass)) {
          bool full = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            sel[r].offer(fmaxf(t[u][r], 0.f), c0 + j, valid);
            full |= sel[r].nv == T;
          }
          if (__any_sync(kFull, full)) {
#pragma unroll
            for (int r = 0; r < R; ++r) sel[r].merge_if(sel[r].nv == T, lane, k);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // chunk c + 1 has landed; every warp is done with buffer b
    if (c + 1 < nchunks) {
      chunk_norms<D, NT>(rows_buf + (b ^ 1) * CH * SD, norm_buf + (b ^ 1) * CH);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) sel[r].merge_if(sel[r].nv > 0, lane, k);
}

// The smallest supported padded width >= d, and warp-queue length >= k.
__host__ inline int width_for(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }
__host__ inline int queue_for(int k) {
  int K = 32;
  while (K < k) K <<= 1;
  return K;
}

// Run L<D, K>::run(args) for the instantiation that serves (d, k).
template <template <int, int> class L, typename A>
__host__ inline int dispatch(int d, int k, const A& args) {
  const int K = queue_for(k);
  switch (width_for(d)) {
#define REPRO_WS_K(D)                                  \
  switch (K) {                                         \
    case 32: return L<D, 32>::run(args);               \
    case 64: return L<D, 64>::run(args);               \
    case 128: return L<D, 128>::run(args);             \
    case 256: return L<D, 256>::run(args);             \
    case 512: return L<D, 512>::run(args);             \
    case 1024: return L<D, 1024>::run(args);           \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
    case 16: REPRO_WS_K(16)
    case 32: REPRO_WS_K(32)
    case 64: REPRO_WS_K(64)
    default: REPRO_WS_K(128)
#undef REPRO_WS_K
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ws
}  // namespace repro
