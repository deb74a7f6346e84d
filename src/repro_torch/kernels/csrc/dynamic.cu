// The exact-dynamic engine's strip kernels (plain C interface, sm_90a).
//
// No Pallas kernel stands behind them: they replace the jnp programs of the
// JAX package's exact-dynamic path,
//   strip_dists         repro/core/dynamic_jax.py::_strip_dists (:145) and
//                       _dense_dists (:126);
//   strip_topk          the four lax.top_k calls of dynamic_jax.py (:187,
//                       :207, :287, :429);
//   strip_round_minima  the strip reductions of one round of
//                       repro/core/mst.py::boruvka_strip_jax (:777-819).
// Each is bit for bit its plain version in kernels/ref.py.
//
// strip_dists: (U, Np) distances sqrt(sum_k (r_k - x_k)^2) in the DIFF form
// (the state holds uncentred coordinates, where the expansion cancels).  A
// block stages a tile of 32 rows and 64 columns, 32 features at a time, in
// shared memory; a thread owns one column and 8 rows and sums over k in
// ascending order with __fsub_rn / __fmul_rn / __fadd_rn, never an FMA
// (nvcc would contract a*b+c), then __fsqrt_rn.  Bound: bytes, the (U, Np)
// write (the inputs are a few MB); warps write 32 consecutive floats.
//
// strip_topk: the masked, ascending K smallest of each strip row.  A warp
// owns a row and streams it, lane j taking columns j, j + 32, ...; each
// candidate is warp_select.cuh's key (distance bits, column), so the order is
// the lexicographic (distance, column) order of the plain version's stable
// sort.  Above the largest warp queue (K > 1024) the row is streamed again
// for each further 1024 keys, above the last key taken.  Bound: bytes, the
// strip read once per 1024 keys.
//
// strip_round_minima: per strip row and per column, the lexicographic
// minimum of (w, canonical pair id, payload) over the active entries
// (smask & lab[sids[row]] != lab[col]).  Rows: a warp per row, lanes on
// consecutive columns, a shuffle reduction at the end.  Columns: a thread per
// column walking the rows, so neighbouring threads read neighbouring
// addresses.  Weights are >= 0, so (w bits << 32 | pair id) orders as the
// tuple does; the payload breaks the rest.  Bound: bytes, SW and smask read
// twice (5 bytes per entry each pass).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "warp_select.cuh"

namespace {

using repro::ws::Key;
using repro::ws::kEmpty;
using repro::ws::kFull;

// ------------------------------------------------------------ strip_dists
constexpr int kTR = 32, kTC = 64, kDK = 32, kDistThreads = 256;
constexpr int kRowsPerThread = kTR / (kDistThreads / kTC);  // 8

__global__ void __launch_bounds__(kDistThreads)
strip_dists_kernel(const float* __restrict__ rows, int U, const float* __restrict__ X, int Np, int d,
                   float* __restrict__ out) {
  __shared__ float rs[kTR][kDK + 1];
  __shared__ float cs[kTC][kDK + 1];
  const int tc = threadIdx.x % kTC, tr = threadIdx.x / kTC;
  const int c0 = blockIdx.x * kTC, r0 = blockIdx.y * kTR;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kDK) {
    const int w = min(kDK, d - k0);
    for (int t = threadIdx.x; t < kTR * kDK; t += kDistThreads) {
      const int r = t / kDK, k = t % kDK;
      rs[r][k] = (r0 + r < U && k < w) ? rows[(size_t)(r0 + r) * d + k0 + k] : 0.f;
    }
    for (int t = threadIdx.x; t < kTC * kDK; t += kDistThreads) {
      const int c = t / kDK, k = t % kDK;
      cs[c][k] = (c0 + c < Np && k < w) ? X[(size_t)(c0 + c) * d + k0 + k] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < w; ++k) {
      const float xc = cs[tc][k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float diff = __fsub_rn(rs[tr * kRowsPerThread + i][k], xc);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(diff, diff));
      }
    }
    __syncthreads();
  }
  const int c = c0 + tc;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r0 + tr * kRowsPerThread + i;
    if (r < U && c < Np) out[(size_t)r * Np + c] = __fsqrt_rn(acc[i]);
  }
}

// ------------------------------------------------------------- strip_topk
constexpr int kTopkWarps = 8;

template <int K>
struct TopkShape {
  static constexpr int T = K <= 64 ? 2 : (K <= 256 ? 4 : 8);  // thread-queue length
};

// One warp per row: rounds of K (the queue) keys, each above the last key
// the previous round took, until k keys are out or the row runs dry.
template <int K>
__global__ void __launch_bounds__(32 * kTopkWarps)
strip_topk_kernel(const float* __restrict__ D, int U, int Np, const int* __restrict__ row_ids,
                  const bool* __restrict__ row_valid, const bool* __restrict__ alive, int k,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int T = TopkShape<K>::T;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kTopkWarps + (threadIdx.x >> 5);
  if (row >= U) return;  // warp-uniform
  const bool rv = row_valid[row];
  const int self = row_ids[row];
  const float* drow = D + (size_t)row * Np;
  Key lo = 0;
  bool dry = false;
  for (int kdone = 0; kdone < k; kdone += K) {
    const int kq = min(K, k - kdone);
    repro::ws::WarpSelect<K, T> sel;
    sel.init();
    if (rv && !dry) {
      for (int j0 = 0; j0 < Np; j0 += 32) {
        const int j = j0 + lane;
        const bool ok = j < Np && alive[j] && j != self;
        const Key key = ok ? repro::ws::make_key(drow[j], j) : kEmpty;
        sel.offer_key(key, ok && key >= lo);
        if (__any_sync(kFull, sel.nv == T)) sel.merge(lane, kq);
      }
      sel.merge_if(sel.nv > 0, lane, kq);
    }
    // write entries kdone .. kdone + kq - 1 (element q * 32 + lane of the queue)
#pragma unroll
    for (int q = 0; q < K / 32; ++q) {
      const int e = q * 32 + lane;
      if (e < kq) {
        const Key key = sel.w[q];
        const float dist = key == kEmpty ? __int_as_float(0x7f800000) : repro::ws::key_dist(key);
        const bool fin = key != kEmpty && isfinite(dist);
        out_d[(size_t)row * k + kdone + e] = dist;
        out_i[(size_t)row * k + kdone + e] = fin ? repro::ws::key_index(key) : -1;
      }
    }
    if (sel.kth == kEmpty) dry = true;  // fewer than kq keys were left
    else lo = sel.kth + 1;
  }
}

template <int K>
int launch_topk(const float* D, int U, int Np, const int* row_ids, const bool* row_valid, const bool* alive, int k,
                float* out_d, int* out_i, cudaStream_t stream) {
  strip_topk_kernel<K><<<(U + kTopkWarps - 1) / kTopkWarps, 32 * kTopkWarps, 0, stream>>>(
      D, U, Np, row_ids, row_valid, alive, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- strip_round_minima
constexpr int kBigId = 0x7fffffff;
constexpr int kRowWarps = 8, kColThreads = 128;

struct Lex {
  Key k;    // (w bits << 32) | pair id
  int pay;  // payload
};

__device__ __forceinline__ Lex lex_empty() {
  return Lex{(static_cast<Key>(0x7f800000u) << 32) | static_cast<unsigned>(kBigId), kBigId};
}
__device__ __forceinline__ bool lex_less(const Lex& a, const Lex& b) {
  return a.k < b.k || (a.k == b.k && a.pay < b.pay);
}
__device__ __forceinline__ Lex lex_entry(float w, int sid, int col, int n, int pay) {
  const int eid = min(sid, col) * n + max(sid, col);
  return Lex{(static_cast<Key>(__float_as_uint(w)) << 32) | static_cast<unsigned>(eid), pay};
}
__device__ __forceinline__ void lex_store(const Lex& b, float* w, int* eid, int* pay, int i) {
  w[i] = __uint_as_float(static_cast<unsigned>(b.k >> 32));
  eid[i] = static_cast<int>(static_cast<unsigned>(b.k));
  pay[i] = b.pay;
}

__global__ void __launch_bounds__(32 * kRowWarps)
round_rows_kernel(const float* __restrict__ SW, const bool* __restrict__ smask, const int* __restrict__ sids,
                  const long long* __restrict__ lab, int U, int n, int E, float* __restrict__ rw,
                  int* __restrict__ re, int* __restrict__ rp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= U) return;  // warp-uniform
  const int sid = sids[row];
  const long long slab = lab[sid];
  const size_t base = (size_t)row * n;
  Lex best = lex_empty();
  for (int j = lane; j < n; j += 32) {
    if (smask[base + j] && lab[j] != slab) {
      const Lex e = lex_entry(SW[base + j], sid, j, n, E + row * n + j);
      if (lex_less(e, best)) best = e;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const Lex o{__shfl_xor_sync(kFull, best.k, off), __shfl_xor_sync(kFull, best.pay, off)};
    if (lex_less(o, best)) best = o;
  }
  if (lane == 0) lex_store(best, rw, re, rp, row);
}

__global__ void __launch_bounds__(kColThreads)
round_cols_kernel(const float* __restrict__ SW, const bool* __restrict__ smask, const int* __restrict__ sids,
                  const long long* __restrict__ lab, int U, int n, int E, float* __restrict__ cw,
                  int* __restrict__ ce, int* __restrict__ cp) {
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= n) return;
  const long long lc = lab[col];
  Lex best = lex_empty();
  for (int r = 0; r < U; ++r) {
    const size_t at = (size_t)r * n + col;
    const int sid = sids[r];
    if (smask[at] && lab[sid] != lc) {
      const Lex e = lex_entry(SW[at], sid, col, n, E + r * n + col);
      if (lex_less(e, best)) best = e;
    }
  }
  lex_store(best, cw, ce, cp, col);
}

}  // namespace

// rows (U, d) and X (Np, d) f32 row-major -> out (U, Np) f32.
extern "C" int repro_strip_dists_f32(const void* rows, int U, const void* X, int Np, int d, void* out,
                                     void* stream) {
  if (U <= 0 || Np <= 0) return 0;
  if (d <= 0 || (U + kTR - 1) / kTR > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Np + kTC - 1) / kTC, (U + kTR - 1) / kTR);
  strip_dists_kernel<<<grid, kDistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), U, static_cast<const float*>(X), Np, d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// D (U, Np) f32, row_ids (U,) int32, row_valid (U,) bool, alive (Np,) bool
// -> out_d (U, k) f32, out_i (U, k) int32.
extern "C" int repro_strip_topk_f32(const void* D, int U, int Np, const void* row_ids, const void* row_valid,
                                    const void* alive, int k, void* out_d, void* out_i, void* stream) {
  if (U <= 0 || k <= 0) return 0;
  const auto* d = static_cast<const float*>(D);
  const auto* ids = static_cast<const int*>(row_ids);
  const auto* rv = static_cast<const bool*>(row_valid);
  const auto* al = static_cast<const bool*>(alive);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (repro::ws::queue_for(k < 1024 ? k : 1024)) {
    case 32: return launch_topk<32>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 64: return launch_topk<64>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 128: return launch_topk<128>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 256: return launch_topk<256>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 512: return launch_topk<512>(d, U, Np, ids, rv, al, k, od, oi, s);
    default: return launch_topk<1024>(d, U, Np, ids, rv, al, k, od, oi, s);
  }
}

// SW (U, n) f32, smask (U, n) bool, sids (U,) int32, lab (n,) int64, payload
// offset E -> row minima (U,) and column minima (n,): w f32, pair id and
// payload int32.
extern "C" int repro_strip_round_minima_f32(const void* SW, const void* smask, const void* sids, const void* lab,
                                            int U, int n, int E, void* rw, void* re, void* rp, void* cw, void* ce,
                                            void* cp, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sw = static_cast<const float*>(SW);
  const auto* sm = static_cast<const bool*>(smask);
  const auto* si = static_cast<const int*>(sids);
  const auto* lb = static_cast<const long long*>(lab);
  if (U > 0) {
    round_rows_kernel<<<(U + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, s>>>(
        sw, sm, si, lb, U, n, E, static_cast<float*>(rw), static_cast<int*>(re), static_cast<int*>(rp));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  round_cols_kernel<<<(n + kColThreads - 1) / kColThreads, kColThreads, 0, s>>>(
      sw, sm, si, lb, U, n, E, static_cast<float*>(cw), static_cast<int*>(ce), static_cast<int*>(cp));
  return static_cast<int>(cudaGetLastError());
}
