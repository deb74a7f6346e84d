// The warp-a-column layout of csrc/grid.cu's first kernels, shared with
// csrc/grid_cd.cu's warp-select route (plain C interface, sm_90a): a block
// of 256 threads per 64 query rows walks its list of the table's tiles; per
// visited tile the block stages the tile's rows in shared memory once for
// all its rows (past kSlice features, slice by slice, the block's rows with
// them); lane j of every warp owns column j of the tile, and each warp
// takes R of the block's rows, whose features it reads by broadcast.
//
// Here: the staged slices' geometry, the staging, the rows' norms, a
// visit's dot products, the warp's minimum, and the Eq. 6 pieces of the
// warp-select layout: R and the thread queue by K, the offer of keys at or
// above a floor, a row's mass walk (Walk) and the warp's walk over a
// queue's keys.  Every norm and dot product is one __fmaf_rn chain over the
// features in ascending order (zero-padded to a multiple of 4, which leaves
// the bits alone), continued slice by slice.
#pragma once

#include "grid_tiles.cuh"
#include "warp_select.cuh"

namespace repro::grid_ws {

using tiles::inf;
using tiles::kMaxTile;
using tiles::kRows;
using tiles::kSlice;
namespace ws = repro::ws;
using ws::Key;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// The staged feature slices of width d: padded width dp (a multiple of 4),
// slice width w, shared-memory row stride sd (sd / 4 odd: the 16-byte
// loads of eight consecutive rows hit distinct banks) and slice count.
struct Slices {
  int d, dp, w, sd, n;
  __host__ __device__ explicit Slices(int d_) : d(d_) {
    dp = (d + 3) & ~3;
    w = dp < kSlice ? dp : kSlice;
    sd = w | 4;
    n = (dp + w - 1) / w;
  }
  __host__ __device__ size_t smem_bytes() const { return sizeof(float) * (size_t)(kRows + kMaxTile) * sd; }
};

// Features [k0, k0 + width) of rows [r0, r0 + rows) of a row-major (n, d)
// table into dst (row stride sd); zero past n and d.  vec4: d % 4 == 0 and
// src 16-byte aligned.  Call with the whole block; the caller synchronises.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int r0, int rows, int n, int d,
                                      int k0, int width, int sd, bool vec4) {
  const int groups = width / 4;
  for (int t = threadIdx.x; t < rows * groups; t += kThreads) {
    const int r = t / groups, f = k0 + 4 * (t - r * groups);
    const int row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      const float* p = src + (size_t)row * d + f;
      if (vec4) {
        if (f < d) v = *reinterpret_cast<const float4*>(p);
      } else {
        if (f < d) v.x = p[0];
        if (f + 1 < d) v.y = p[1];
        if (f + 2 < d) v.z = p[2];
        if (f + 3 < d) v.w = p[3];
      }
    }
    *reinterpret_cast<float4*>(dst + r * sd + (f - k0)) = v;
  }
}

// Squared norm of `row` of a (n, d) table as one ascending chain.
__device__ __forceinline__ float row_norm(const float* __restrict__ src, int row, int n, int d) {
  return row < n ? repro::dot_chain(src + (size_t)row * d, src + (size_t)row * d, d) : 0.f;
}

// The norms of this warp's R rows (row0 ..): lane r chains row r, then
// every lane takes them all.
template <int R>
__device__ __forceinline__ void warp_norms(const float* __restrict__ src, int row0, int n, int d, float (&xx)[R]) {
  const int lane = threadIdx.x & 31;
  const float mine = lane < R ? row_norm(src, row0 + lane, n, d) : 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) xx[r] = __shfl_sync(ws::kFull, mine, r);
}

// One visit: the dot products of this lane's column of tile `tile` with the
// warp's R staged rows (xs rows row_off ..), and the column's squared norm,
// each one chain over the features in ascending order.  Stages the tile
// (and, past one slice, the block's rows) slice by slice; call with the
// whole block.
template <int R>
__device__ __forceinline__ void visit(float* xs, float* ys, const float* __restrict__ x, int x0, int xn,
                                      const float* __restrict__ pts, int tile, int T, int Lp, const Slices& s,
                                      bool vec4x, bool vec4y, int row_off, float (&acc)[R], float& yy) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  yy = 0.f;
  for (int sl = 0; sl < s.n; ++sl) {
    const int k0 = sl * s.w, width = min(s.w, s.dp - k0);
    if (s.n > 1) stage(xs, x, x0, kRows, xn, s.d, k0, width, s.sd, vec4x);
    stage(ys, pts, tile * T, T, Lp, s.d, k0, width, s.sd, vec4y);
    __syncthreads();
    if (lane < T) {
      const float4* yp = reinterpret_cast<const float4*>(ys + lane * s.sd);
      const float4* xp = reinterpret_cast<const float4*>(xs + row_off * s.sd);
      const int q = s.sd / 4;
      for (int g = 0; g < width / 4; ++g) {
        const float4 v = yp[g];
        yy = __fmaf_rn(v.x, v.x, yy);
        yy = __fmaf_rn(v.y, v.y, yy);
        yy = __fmaf_rn(v.z, v.z, yy);
        yy = __fmaf_rn(v.w, v.w, yy);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 u = xp[r * q + g];
          acc[r] = __fmaf_rn(u.x, v.x, acc[r]);
          acc[r] = __fmaf_rn(u.y, v.y, acc[r]);
          acc[r] = __fmaf_rn(u.z, v.z, acc[r]);
          acc[r] = __fmaf_rn(u.w, v.w, acc[r]);
        }
      }
    }
    __syncthreads();  // every warp is done with this slice before the next is staged
  }
}

// The warp's minimum of a value >= 0 (or +inf); -0 counts as +0.
__device__ __forceinline__ float warp_min_nonneg(float v) {
  return __uint_as_float(__reduce_min_sync(ws::kFull, __float_as_uint(v) & 0x7fffffffu));
}

// ------------------------------------------------- Eq. 6, the warp-select layout
// A warp takes R rows at a time (R by the queue's registers), so a block
// makes kRows / (8 R) passes over its tiles.
template <int K>
struct CdShape {
  static constexpr int T = K <= 64 ? 2 : (K <= 256 ? 4 : 8);  // thread-queue length
  static constexpr int R = K <= 64 ? 8 : (K <= 128 ? 4 : (K <= 256 ? 2 : 1));
  static constexpr int kPasses = kRows / (kWarps * R);
};

// WarpSelect::offer for keys at or above lo only.
template <int K, int T>
__device__ __forceinline__ void offer_from(ws::WarpSelect<K, T>& s, float sq, int j, bool valid, Key lo) {
  if (valid && !(sq >= s.thr2)) {
    const Key key = ws::make_key(sqrtf(sq), j);
    if (key >= lo && key < s.kth) {
#pragma unroll
      for (int t = T - 1; t > 0; --t) s.tq[t] = s.tq[t - 1];
      s.tq[0] = key;
      ++s.nv;
    }
  }
}

// A row's Eq. 6 walk over its keys in ascending order: the masses added
// one __fadd_rn at a time up to the min_pts crossing.
struct Walk {
  float csum = 0.f, m_last = 0.f, nb_last = 0.f, ext_last = 0.f;
  float dstar = 0.f, before = 0.f, nb_c = 1.f, ext_c = 0.f;
  bool done = false, ended = false;

  __device__ __forceinline__ void take(float m, float nb, float ext, float mp) {
    const float next = __fadd_rn(csum, nb);
    if (next >= mp) {
      dstar = m;
      before = csum;
      nb_c = nb;
      ext_c = ext;
      done = true;
    } else {
      csum = next;
      m_last = m;
      nb_last = nb;
      ext_last = ext;
    }
  }
  // Eq. 6; short of min_pts, the last entry plays the crossing bubble.
  __device__ __forceinline__ float value(float mp, int dim) const {
    if (done) return repro::eq6_core_distance(dstar, before, nb_c, ext_c, mp, dim);
    return repro::eq6_core_distance(m_last, __fsub_rn(csum, nb_last), nb_last, ext_last, mp, dim);
  }
};

// The Eq. 6 walk over one row's selected keys: entries 0 .. kq - 1 of the
// queue in ascending order, continuing st from earlier rounds.
template <int K, int T>
__device__ __forceinline__ void walk(const ws::WarpSelect<K, T>& sel, int kq, const float* __restrict__ nb,
                                     const float* __restrict__ ext, float mp, Walk& st) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < K / 32; ++q) {
    if (st.done || st.ended || q * 32 >= kq) break;
    const int e = q * 32 + lane;
    const Key key = sel.w[q];
    const bool real = e < kq && key != ws::kEmpty;
    const float dist = ws::key_dist(key);
    float nb_e = 0.f, ext_e = 0.f;
    if (real) {
      nb_e = nb[ws::key_index(key)];
      ext_e = ext[ws::key_index(key)];
    }
    const int cnt = __popc(__ballot_sync(ws::kFull, real));  // the real keys are a prefix
#pragma unroll 1
    for (int t = 0; t < cnt; ++t) {
      st.take(__shfl_sync(ws::kFull, dist, t), __shfl_sync(ws::kFull, nb_e, t), __shfl_sync(ws::kFull, ext_e, t),
              mp);
      if (st.done) break;
    }
    if (!st.done && cnt < min(32, kq - q * 32)) st.ended = true;  // no valid row left
  }
}

}  // namespace repro::grid_ws
