// The grid-pruned exact searches of spatial_index=True (kernels/grid.py):
// the ports of the JAX package's jnp programs repro/kernels/grid.py::
// grid_assign (:355), grid_core_distances (:222, _cd_block_values :255) and
// repro/core/mst.py::_grid_round_minima (:392).  No Pallas kernel stands
// behind them; on the TPU they are lax.scan / while_loop programs.  The
// three kernels here are the first kernels, redesigned in
// csrc/grid_assign.cu, csrc/grid_cd.cu and csrc/grid_round.cu (a thread a
// row, a prefetched tile ring, the walk split across a cluster), and stay as
// those kernels' bitwise oracles (grid_assign_v1, grid_core_distances_v1,
// grid_round_minima_v1), launched on no path.
//
// The layout of this file's kernels: one block per 64 query rows (kRows).
// The table is Morton-sorted into tiles of T <= 32 rows, and each block
// walks its own list of tiles in ascending lower bound (order, lbs:
// computed by torch code in grid.py).  Per visited tile, the block stages
// the tile's rows in shared memory once for all its rows; lane j of every
// warp owns column j of the tile, and each warp takes R of the block's rows,
// whose features it reads by broadcast.  After the visit each thread votes
// whether any of its rows could still gain from the NEXT tile, and
// __syncthreads_or ends the walk at the first tile none could: the skip is
// strict (a bound equal to an answer is visited), so ties are never lost.
// The loops end inside the kernel; the host reads nothing.
//
// Exactness against the dense kernels.  Every norm and dot product is one
// __fmaf_rn chain over the features in ascending order (zero-padded to a
// multiple of 4, which leaves the bits alone), then common.cuh's
// expanded_sq, a correctly rounded sqrtf and the same fmaxf: so a candidate
// carries the bits of the dense matrix entry (assign_ws.cu, bubble_cd_ws.cu,
// dist_panel.cu).  Features are staged in slices of kSlice, the chains
// continued slice by slice, so any d runs.  Answers merge on (value,
// ORIGINAL row index), the order of the dense tie-breaks; invalid rows are
// never candidates.
//
// Bound on the H100: operations, 64 x 32 x d FMAs per visited tile; the
// table, visit lists and outputs are a few MB.  These kernels are simple,
// not fast: one tile in flight per block (no cp.async ring), and a table's
// own rows as queries give NB = Lp / 64 blocks, 128 at Lp = 8192 on 132 SMs.
#include "grid_ws.cuh"

namespace {

// The block, the staging, the norms, a visit, the warp's minimum and the
// Eq. 6 kernel's queue shape, offers and walk: grid_ws.cuh, which
// grid_cd.cu's warp-select route shares; the launch's checks: grid_tiles.cuh.
using namespace repro::grid_ws;
using repro::tiles::bad_blocks;
using repro::tiles::bad_grid;

__device__ __forceinline__ bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---------------------------------------------------------------- assign
// Query rows x (n, d), Morton-sorted; per row the lexicographic minimum of
// (expanded_sq, original index) over the valid rows, as assign_ws.cu
// computes it over every row.  Outputs in the queries' sorted order: the
// original index (Lp if the table has no valid row) and sqrtf of the minimum.
constexpr int kWarpRows = kRows / kWarps;  // rows per warp of the assign and Borůvka kernels

__global__ void __launch_bounds__(kThreads)
grid_assign_kernel(const float* __restrict__ x, int n, const float* __restrict__ pts, const int* __restrict__ orig,
                   const bool* __restrict__ valid, int Lp, int d, int T, const int* __restrict__ order,
                   const float* __restrict__ lbs, int NT, int* __restrict__ idx_out, float* __restrict__ dist_out,
                   unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kWarpRows;
  const Slices s(d);
  float* xs = smem;
  float* ys = smem + kRows * s.sd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kRows, row_off = warp * R;
  const bool vec4x = d % 4 == 0 && aligned16(x), vec4y = d % 4 == 0 && aligned16(pts);
  const int* ord = order + (size_t)blockIdx.x * NT;
  const float* lb = lbs + (size_t)blockIdx.x * NT;
  if (s.n == 1) stage(xs, x, x0, kRows, n, d, 0, s.dp, s.sd, vec4x);  // visible after visit's first barrier

  float xx[R], best[R];
  int bidx[R];
  warp_norms<R>(x, x0 + row_off, n, d, xx);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = inf();
    bidx[r] = INT_MAX;
  }
  int visited = 0;
  bool go = NT > 0 && lb[0] < inf();
  for (int t = 0; go; ++t) {
    const int tile = ord[t];
    float acc[R], yy;
    visit<R>(xs, ys, x, x0, n, pts, tile, T, Lp, s, vec4x, vec4y, row_off, acc, yy);
    const int p = tile * T + lane;
    const bool cv = lane < T && valid[p];
    const int co = cv ? orig[p] : INT_MAX;
    if (cv) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float sq = repro::expanded_sq(xx[r], yy, acc[r]);
        if (sq < best[r] || (sq == best[r] && co < bidx[r])) {
          best[r] = sq;
          bidx[r] = co;
        }
      }
    }
    ++visited;
    bool want = false;
    const float nl = t + 1 < NT ? lb[t + 1] : inf();
    if (nl < inf()) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rb = warp_min_nonneg(best[r]);
        want |= x0 + row_off + r < n && nl <= rb;
      }
    }
    go = __syncthreads_or(want);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    repro::warp_argmin(best[r], bidx[r]);
    const int row = x0 + row_off + r;
    if (lane == 0 && row < n) {
      idx_out[row] = bidx[r] == INT_MAX ? Lp : bidx[r];
      dist_out[row] = sqrtf(best[r]);
    }
  }
  if (visits != nullptr && threadIdx.x == 0) {
    atomicAdd(visits, (unsigned long long)visited * min(kRows, n - x0));
    atomicMax(visits + 1, (unsigned long long)visited);  // the longest walk of a block
  }
}

// ------------------------------------------------------- Borůvka round
// The table's own rows as queries (sorted position p, original o).  Per
// live row (valid, not hopeless) the lexicographic minimum of
// (w, eid) over valid columns of another label, with
// w = fmaxf(sqrtf(expanded_sq), fmaxf(cd_r, cd_c)) (dist_panel.cu's Eq. 7
// bits) and eid = min(o_r, o_c) * Lp + max(o_r, o_c); +inf / INT_MAX where
// none.  The next tile is visited while max(lb, cd_r) <= the row's best w
// for any live row.  Outputs in sorted order.
__global__ void __launch_bounds__(kThreads)
grid_round_kernel(const float* __restrict__ pts, const int* __restrict__ orig, const bool* __restrict__ valid, int Lp,
                  int d, int T, const int* __restrict__ order, const float* __restrict__ lbs, int NT,
                  const float* __restrict__ cd, const long long* __restrict__ labels,
                  const bool* __restrict__ hopeless, int block0, float* __restrict__ w_out,
                  int* __restrict__ eid_out, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kWarpRows;
  const Slices s(d);
  float* xs = smem;
  float* ys = smem + kRows * s.sd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = block0 + blockIdx.x;
  const int x0 = blk * kRows, row_off = warp * R;
  const bool vec4 = d % 4 == 0 && aligned16(pts);
  const int* ord = order + (size_t)blk * NT;
  const float* lb = lbs + (size_t)blk * NT;
  if (s.n == 1) stage(xs, pts, x0, kRows, Lp, d, 0, s.dp, s.sd, vec4);

  float xx[R], cd_r[R], bw[R];
  int o_r[R], be[R];
  long long lab_r[R];
  bool alive[R];
  warp_norms<R>(pts, x0 + row_off, Lp, d, xx);
  bool any_alive = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = x0 + row_off + r;
    alive[r] = p < Lp && valid[p];
    o_r[r] = alive[r] ? orig[p] : 0;
    alive[r] = alive[r] && !hopeless[o_r[r]];
    lab_r[r] = alive[r] ? labels[o_r[r]] : -1;
    cd_r[r] = alive[r] ? cd[o_r[r]] : 0.f;
    bw[r] = inf();
    be[r] = INT_MAX;
    any_alive |= alive[r];
  }
  int visited = 0;
  bool go = __syncthreads_or(any_alive) && NT > 0 && lb[0] < inf();
  for (int t = 0; go; ++t) {
    const int tile = ord[t];
    float acc[R], yy;
    visit<R>(xs, ys, pts, x0, Lp, pts, tile, T, Lp, s, vec4, vec4, row_off, acc, yy);
    const int p = tile * T + lane;
    const bool cv = lane < T && valid[p];
    if (cv) {
      const int o_c = orig[p];
      const long long lab_c = labels[o_c];
      const float cd_c = cd[o_c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (alive[r] && lab_c != lab_r[r]) {
          const float w = fmaxf(sqrtf(repro::expanded_sq(xx[r], yy, acc[r])), fmaxf(cd_r[r], cd_c));
          const int e = min(o_r[r], o_c) * Lp + max(o_r[r], o_c);
          if (w < bw[r] || (w == bw[r] && e < be[r])) {
            bw[r] = w;
            be[r] = e;
          }
        }
      }
    }
    ++visited;
    bool want = false;
    const float nl = t + 1 < NT ? lb[t + 1] : inf();
    if (nl < inf()) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rb = warp_min_nonneg(bw[r]);
        want |= alive[r] && fmaxf(nl, cd_r[r]) <= rb;
      }
    }
    go = __syncthreads_or(want);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // lexicographic (w, eid) across the warp
    float v = bw[r];
    int e = be[r];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(ws::kFull, v, off);
      const int oe = __shfl_xor_sync(ws::kFull, e, off);
      if (ov < v || (ov == v && oe < e)) {
        v = ov;
        e = oe;
      }
    }
    const int row = x0 + row_off + r;
    if (lane == 0 && row < Lp) {
      w_out[row - block0 * kRows] = v;
      eid_out[row - block0 * kRows] = e;
    }
  }
  if (visits != nullptr && threadIdx.x == 0) atomicAdd(visits, (unsigned long long)visited * min(kRows, Lp - x0));
}

// ------------------------------------------------- Eq. 6 core distances
// Per valid row, the first k = min(min_pts, Lp) entries of its (distance,
// original index) order over the valid rows -- itself at exactly 0 --
// selected by warp_select.cuh's queue (keys (distance bits, ORIGINAL
// index)), then bubble_cd_ws.cu's walk: masses added one __fadd_rn at a
// time in that order up to the min_pts crossing, and common.cuh's Eq. 6.
// A warp takes R rows at a time (R by the queue's registers), so a block
// makes kRows / (8 R) passes over its tiles.  Above the largest queue
// (k > 1024) a pass runs in rounds: each round selects the next 1024 keys
// above the last one taken and the walk carries on from where it stopped,
// until the crossing.  A tile is visited while its bound is at most some
// still-walking row's queued k-th distance.  Invalid rows write 0; output in
// ORIGINAL order.
template <int K>
__global__ void __launch_bounds__(kThreads)
grid_cd_kernel(const float* __restrict__ pts, const int* __restrict__ orig, const bool* __restrict__ valid, int Lp,
               int d, int T, const int* __restrict__ order, const float* __restrict__ lbs, int NT,
               const float* __restrict__ nb, const float* __restrict__ ext, int k, int min_pts, int dim,
               int block0, float* __restrict__ out, unsigned long long* __restrict__ visits) {
  extern __shared__ __align__(16) float smem[];
  using S = CdShape<K>;
  constexpr int R = S::R, TQ = S::T;
  const Slices s(d);
  float* xs = smem;
  float* ys = smem + kRows * s.sd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = block0 + blockIdx.x;
  const int x0 = blk * kRows;
  const bool vec4 = d % 4 == 0 && aligned16(pts);
  const int* ord = order + (size_t)blk * NT;
  const float* lb = lbs + (size_t)blk * NT;
  const float mp = static_cast<float>(min_pts);
  if (s.n == 1) stage(xs, pts, x0, kRows, Lp, d, 0, s.dp, s.sd, vec4);
  unsigned long long visited = 0;
  int walked = 0;  // tiles this block visited, over its passes and rounds

  for (int pass = 0; pass < S::kPasses; ++pass) {
    const int row_off = pass * kWarps * R + warp * R;
    float xx[R];
    int o_r[R];
    bool rv[R];
    Key lo[R];
    Walk st[R];
    warp_norms<R>(pts, x0 + row_off, Lp, d, xx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = x0 + row_off + r;
      rv[r] = p < Lp && valid[p];
      o_r[r] = p < Lp ? orig[p] : -1;
      lo[r] = 0;
    }
    for (int kdone = 0; kdone < k; kdone += K) {
      const int kq = min(K, k - kdone);
      bool need[R], any_need = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        need[r] = rv[r] && !st[r].done && !st[r].ended;
        any_need |= need[r];
      }
      if (!__syncthreads_or(any_need)) break;
      ws::WarpSelect<K, TQ> sel[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sel[r].init();
      const int rows_here = max(0, min(kWarps * R, Lp - (x0 + pass * kWarps * R)));  // of the block, this pass
      bool go = NT > 0 && lb[0] < inf();
      for (int t = 0; go; ++t) {
        const int tile = ord[t];
        float acc[R], yy;
        visit<R>(xs, ys, pts, x0, Lp, pts, tile, T, Lp, s, vec4, vec4, row_off, acc, yy);
        const int p = tile * T + lane;
        const bool cv = lane < T && valid[p];
        const int o_c = cv ? orig[p] : 0;
        float sq[R];
        bool pass_any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float tt = __fsub_rn(__fadd_rn(xx[r], yy), __fmul_rn(2.f, acc[r]));
          if (o_c == o_r[r]) tt = 0.f;  // the row itself, exactly 0
          sq[r] = fmaxf(tt, 0.f);
          pass_any |= need[r] && cv && !(sq[r] >= sel[r].thr2);
        }
        if (__any_sync(ws::kFull, pass_any)) {
          bool full = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            offer_from(sel[r], sq[r], o_c, need[r] && cv, lo[r]);
            full |= sel[r].nv == TQ;
          }
          if (__any_sync(ws::kFull, full)) {
#pragma unroll
            for (int r = 0; r < R; ++r) sel[r].merge_if(sel[r].nv == TQ, lane, kq);
          }
        }
        visited += rows_here;
        ++walked;
        bool want = false;
        const float nl = t + 1 < NT ? lb[t + 1] : inf();
        if (nl < inf()) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float kd = sel[r].kth == ws::kEmpty ? inf() : ws::key_dist(sel[r].kth);
            want |= need[r] && nl <= kd;
          }
        }
        go = __syncthreads_or(want);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sel[r].merge_if(sel[r].nv > 0, lane, kq);
        if (need[r]) {
          walk(sel[r], kq, nb, ext, mp, st[r]);
          if (!st[r].done) {
            if (sel[r].kth == ws::kEmpty) st[r].ended = true;
            else lo[r] = sel[r].kth + 1;  // the next round takes the keys above this one's last
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = x0 + row_off + r;
      if (lane == 0 && p < Lp) {
        float v = 0.f;
        if (rv[r]) {
          Walk& w = st[r];
          if (!w.done) {  // mass below min_pts: the last entry plays the crossing bubble
            w.dstar = w.m_last;
            w.before = __fsub_rn(w.csum, w.nb_last);
            w.nb_c = w.nb_last;
            w.ext_c = w.ext_last;
          }
          v = repro::eq6_core_distance(w.dstar, w.before, w.nb_c, w.ext_c, mp, dim);
        }
        out[p - block0 * kRows] = v;
      }
    }
  }
  if (visits != nullptr && threadIdx.x == 0) {
    atomicAdd(visits, visited);
    atomicMax(visits + 1, (unsigned long long)walked);  // the longest walk of a block
  }
}

template <typename Kernel>
int prepare(Kernel kernel, const Slices& s) {
  return static_cast<int>(repro::allow_smem(kernel, s.smem_bytes()));
}

struct CdArgs {
  const float* pts;
  const int* orig;
  const bool* valid;
  int Lp, d, T;
  const int* order;
  const float* lbs;
  int NT;
  const float* nb;
  const float* ext;
  int k, min_pts, dim, block0, nblocks;
  float* out;
  unsigned long long* visits;
  cudaStream_t stream;
};

template <int K>
int launch_cd(const CdArgs& a) {
  const Slices s(a.d);
  const auto kernel = grid_cd_kernel<K>;
  const int err = prepare(kernel, s);
  if (err != 0) return err;
  kernel<<<a.nblocks, kThreads, s.smem_bytes(), a.stream>>>(
      a.pts, a.orig, a.valid, a.Lp, a.d, a.T, a.order, a.lbs, a.NT, a.nb, a.ext, a.k, a.min_pts, a.dim, a.block0,
      a.out, a.visits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, d) Morton-sorted queries; pts (Lp, d), orig (Lp,) int32, valid (Lp,)
// bool: the sorted table in NT tiles of T rows; order (ceil(n / 64), NT)
// int32 and lbs (ceil(n / 64), NT) f32 each block's tiles by ascending
// lb_sq - slack; idx_out (n,) int32, dist_out (n,) f32 in sorted order;
// visits: null or two 64-bit counters (row-tile visits, added; the longest
// walk of a block, a maximum).  Returns cudaGetLastError() after the launch.
extern "C" int repro_grid_assign_f32(const void* x, int n, const void* pts, const void* orig, const void* valid,
                                     int Lp, int d, int T, const void* order, const void* lbs, int NT,
                                     void* idx_out, void* dist_out, void* visits, void* stream) {
  if (n <= 0 || bad_grid(Lp, d, T, NT)) return static_cast<int>(cudaErrorInvalidValue);
  const Slices s(d);
  const int err = prepare(grid_assign_kernel, s);
  if (err != 0) return err;
  grid_assign_kernel<<<(n + kRows - 1) / kRows, kThreads, s.smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const float*>(pts), static_cast<const int*>(orig),
      static_cast<const bool*>(valid), Lp, d, T, static_cast<const int*>(order), static_cast<const float*>(lbs), NT,
      static_cast<int*>(idx_out), static_cast<float*>(dist_out), static_cast<unsigned long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}

// The sorted table as above, its own rows as queries in ceil(Lp / 64)
// blocks, of which this launch runs [block0, block0 + nblocks) (a shard's
// range in the sharded offline pass; each block's values do not depend on
// which blocks share the launch); nb, ext (Lp,) f32 in original order;
// 1 <= k = min(min_pts, Lp); out (nblocks * 64,) f32: the blocks' rows in
// sorted order (0 on invalid rows); visits: null or two 64-bit counters
// (row-tile visits, added; the longest walk of a block, a maximum).
extern "C" int repro_grid_core_distances_f32(const void* pts, const void* orig, const void* valid, int Lp, int d,
                                             int T, const void* order, const void* lbs, int NT, const void* nb,
                                             const void* ext, int k, int min_pts, int dim, int block0, int nblocks,
                                             void* out, void* visits, void* stream) {
  if (bad_grid(Lp, d, T, NT) || bad_blocks(Lp, block0, nblocks) || k < 1 || k > Lp || min_pts < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CdArgs a{static_cast<const float*>(pts), static_cast<const int*>(orig), static_cast<const bool*>(valid),
                 Lp, d, T, static_cast<const int*>(order), static_cast<const float*>(lbs), NT,
                 static_cast<const float*>(nb), static_cast<const float*>(ext), k, min_pts, dim, block0, nblocks,
                 static_cast<float*>(out), static_cast<unsigned long long*>(visits),
                 static_cast<cudaStream_t>(stream)};
  switch (ws::queue_for(min(k, ws::kMaxK))) {
    case 32: return launch_cd<32>(a);
    case 64: return launch_cd<64>(a);
    case 128: return launch_cd<128>(a);
    case 256: return launch_cd<256>(a);
    case 512: return launch_cd<512>(a);
    default: return launch_cd<1024>(a);
  }
}

// The sorted table as above, the query blocks [block0, block0 + nblocks);
// cd (Lp,) f32, labels (Lp,) int64 and hopeless (Lp,) bool in original
// order; w_out (nblocks * 64,) f32 and eid_out (nblocks * 64,) int32: the
// blocks' rows in sorted order.
extern "C" int repro_grid_round_minima_f32(const void* pts, const void* orig, const void* valid, int Lp, int d, int T,
                                           const void* order, const void* lbs, int NT, const void* cd,
                                           const void* labels, const void* hopeless, int block0, int nblocks,
                                           void* w_out, void* eid_out, void* visits, void* stream) {
  if (bad_grid(Lp, d, T, NT) || bad_blocks(Lp, block0, nblocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Slices s(d);
  const int err = prepare(grid_round_kernel, s);
  if (err != 0) return err;
  grid_round_kernel<<<nblocks, kThreads, s.smem_bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const int*>(orig), static_cast<const bool*>(valid), Lp, d, T,
      static_cast<const int*>(order), static_cast<const float*>(lbs), NT, static_cast<const float*>(cd),
      static_cast<const long long*>(labels), static_cast<const bool*>(hopeless), block0, static_cast<float*>(w_out),
      static_cast<int*>(eid_out), static_cast<unsigned long long*>(visits));
  return static_cast<int>(cudaGetLastError());
}
