// The grid Borůvka round's search redesigned for Hopper (plain C interface,
// sm_90a): per live row of the Morton-sorted table, the lexicographic
// minimum of (w, eid) over the valid columns of another label, with
//   w   = fmaxf(sqrtf(expanded_sq(xx, yy, acc)), fmaxf(cd_r, cd_c)),
//   eid = min(o_r, o_c) * Lp + max(o_r, o_c),
// (+inf, INT_MAX) for invalid or hopeless rows and rows that find nothing.
// It replaces the JAX package's jnp program repro/core/mst.py::
// _grid_round_minima (:392) on every path (kernels/grid.py::
// grid_round_minima); no Pallas kernel stands behind it.  The first kernel,
// csrc/grid.cu's grid_round_kernel, stays as its bitwise oracle
// (grid_round_minima_v1) and runs on no path.
//
// What held the first kernel: one CTA of 256 threads per 64 query rows
// walked the block's tiles in ascending lower bound one at a time, and each
// visit paid a global round trip (the tile staged behind a barrier, then the
// dependent gathers valid[p] -> orig[p] -> labels[o], cd[o] per column) for
// 8 rows x d FMAs a thread, two barriers and a vote.  A working round's time
// was its longest walk, 164 of 256 tiles at Lp = 8192, at ~2.5 us a visit.
// Bound on the H100: operations, 2·d FLOPs per (row, visited column).
//
// The design (the sizes, the ring's geometry and copies, the header ring,
// the cluster's merge and launch are grid_tiles.cuh's, shared with
// csrc/grid_assign.cu):
//  * The walk is split across a thread-block cluster of C CTAs per 64-row
//    block (cudaLaunchKernelEx with a cluster dimension; kernels/grid.py
//    launches C = 8): rank r visits positions r, r + C, r + 2C, ... of the
//    block's order.  Each CTA stops on its own bests: it goes on while any
//    live row has max(lb_next, cd_r) <= its best w.  A CTA's best is a real
//    candidate's w, at least the row's final answer, and the bounds ascend,
//    so every skipped tile holds only candidates strictly worse than the
//    answer: the stop is conservative and exact (ties are visited).  At the
//    end the C partial (w, eid) per row merge through distributed shared
//    memory, lexicographically, which is order-free: the bits do not depend
//    on C.
//  * A thread owns a query row: its features in registers (d <= 16; wider
//    d 16 at a time from shared memory), its best (w, eid) and its filter
//    threshold.  It sweeps the tile's 32 columns, whose features every lane
//    reads by broadcast, one ascending FMA chain each.  No per-row state is
//    replicated across lanes and no warp reduction runs a visit: the stop
//    vote is one __syncthreads_or over the CTA's 2 warps (64 rows).  CTAs
//    of 64 threads at <= 128 registers let the 1024 CTAs of C = 8 at Lp =
//    8192 run in one wave, 8 an SM, whose warps hide each other's latency:
//    the work of a visit is a few dependent chains, and with 1-2 warps a
//    scheduler (C = 2) the latency, not the issue rate, set the pace.
//  * A ring of S stages in shared memory, filled kAhead = S - 1 visits
//    ahead by 16-byte cp.async copies (4-byte where d % 4 != 0 or the table
//    is not 16-byte aligned).  A stage holds a tile's 32 rows (past one slice of kSlice
//    features, a slice of them and of the block's 64 query rows), row stride
//    sd = w | 4 floats (an odd count of 16-byte groups: the 16-byte loads of
//    8 consecutive rows hit distinct banks).  Copies fetched past the stop
//    point are dropped.
//  * The column attributes travel with the tile.  One warp (the gather
//    warp) reads each upcoming tile's orig[p] and valid[p] into registers
//    a visit before its copies start, and at the end of the visit that
//    starts them issues 8- and 4-byte cp.async gathers of labels[o] and
//    cd[o] into the same stage, in the same commit group: no dependent load
//    is left on the walk's critical path.  The tile and bound of each visit
//    reach the block through a small header ring a visit before its copies.
//    Lane c of each warp chains column c's yy and hands it out through
//    shared memory.
//  * Every column of a visit, with no branch and no chain through the
//    columns: the tests sq <= thr (thr the square of the successor of the
//    row's best at the visit's start, rounded up: a larger sq has a root
//    above that best), cd_c^2 rounded down <= thr (a larger one puts cd_c
//    above it) and another label, an invalid column's yy NaN, which fails
//    them, into a mask; then, only in a visit where a row of the warp keeps
//    a column, the exact (w, eid) of the kept columns into four running
//    lexicographic minima, merged into the row's best once.  Updating the
//    best (and thr) column by column made a chain through the 32 columns.
//  * An empty round costs a launch: the block's 64 rows' valid / hopeless
//    are read first, and a block with no live row writes its (+inf,
//    INT_MAX) and leaves before it stages or chains anything.
//
// Bits: every acc and yy is one ascending __fmaf_rn chain over the
// features (zero-padded to the compiled width 16, 32, 64 or 128, which
// leaves the bits alone: a chain from +0 never holds -0), continued slice
// by slice past 128 features, so any d runs; sq is common.cuh's
// expanded_sq and w takes the correctly rounded sqrtf as the first kernel
// does; xx is common.cuh's dot_chain; no tensor cores, no TF32.  Ties
// merge on (w, eid).
//
// python -m repro_torch.kernels.grid_variants times other ring depths, the
// cluster size (an argument), and variants it patches into this source: 1-D
// bulk copies on mbarriers, a label skip, and probes of where the time goes.
#include "grid_tiles.cuh"

namespace {

using namespace repro::tiles;

constexpr int kStages = 4;  // ring depth S: visits in flight = S - 1

constexpr int kAhead = kStages - 1;
constexpr int kHdr = kAhead + 2;  // header ring: written a visit before the copies, read up to kAhead after
constexpr int kSub = 16;          // features a register slice of the row
constexpr int kGatherWarp = kWarps - 1;

static_assert(kStages >= 1 && kAhead + 2 <= 32, "ring depth");

// Shared-memory plan: the ring (grid_tiles.cuh's Slices), then the offsets
// (bytes) of this kernel's regions.
struct Plan : Slices {
  size_t labc, ocol, cdc, hdr_t, hdr_l, fw, fe, cval, bytes;
  __host__ __device__ Plan(int d_, int DP) : Slices(d_, DP, kStages) {
    size_t at = end;
    labc = at;
    at += sizeof(long long) * kStages * kMaxTile;
    ocol = at;
    at += sizeof(int) * kStages * kMaxTile;
    cdc = at;
    at += sizeof(float) * kStages * kMaxTile;
    hdr_t = at;
    at += sizeof(int) * kHdr;
    hdr_l = at;
    at += sizeof(float) * kHdr;
    fw = at;
    at += sizeof(float) * kRows;
    fe = at;
    at += sizeof(int) * kRows;
    cval = at = (at + 15) & ~size_t(15);
    at += sizeof(float4) * kWarps * kMaxTile;
    bytes = (at + 15) & ~size_t(15);
  }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

struct Args {
  const float* pts;
  const int* orig;
  const bool* valid;
  int Lp, d, T;
  const int* order;
  const float* lbs;
  int NT;
  const float* cd;
  const long long* labels;
  const bool* hopeless;
  int block0;
  float* w_out;
  int* eid_out;
  unsigned long long* visits;  // null, or [rows x tiles visited, the longest walk of a CTA]
};

// A tile column's raw (orig, valid, in range).
struct Col {
  int o;
  bool v, ok;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 8)
grid_round_tiles_kernel(const Args a, int C) {
  constexpr int KS = DP > 0 && DP < kSub ? DP : kSub;  // features a register slice
  constexpr bool kHeld = DP > 0 && DP <= kSub;         // the row's features stay in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan P(a.d, DP);
  float* xs = reinterpret_cast<float*>(smem + P.xs);
  float* stages = reinterpret_cast<float*>(smem + P.stages);
  int* ocol = reinterpret_cast<int*>(smem + P.ocol);
  long long* labc = reinterpret_cast<long long*>(smem + P.labc);
  float* cdc = reinterpret_cast<float*>(smem + P.cdc);
  int* hdr_t = reinterpret_cast<int*>(smem + P.hdr_t);
  float* hdr_l = reinterpret_cast<float*>(smem + P.hdr_l);
  float* fw = reinterpret_cast<float*>(smem + P.fw);
  int* fe = reinterpret_cast<int*>(smem + P.fe);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* cval = reinterpret_cast<float4*>(smem + P.cval) + warp * kMaxTile;  // this warp's copy
  const int rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const int blk = a.block0 + static_cast<int>(blockIdx.x) / C;
  const int x0 = blk * kRows, row = x0 + tid;
  const int Lp = a.Lp, T = a.T, NT = a.NT, sn = DP > 0 ? 1 : P.sn;
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.pts) % 16 == 0;

  // The block's rows first: an empty round leaves here.  Every load of a
  // level is issued before any is used.
  const int p_row = min(row, Lp - 1);
  const bool v_row = row < Lp && a.valid[p_row];
  const int o_r = a.orig[p_row];
  const bool live = v_row && !a.hopeless[o_r];
  const long long lab_r = a.labels[o_r];
  const float cd_r = a.cd[o_r];
  if (!__syncthreads_or(live)) {
    if (rank == 0 && row < Lp) {
      a.w_out[row - a.block0 * kRows] = inf();
      a.eid_out[row - a.block0 * kRows] = INT_MAX;
    }
    return;
  }

  // Iteration q: visit q / sn, feature slice q % sn.
  auto load_col = [&](int tile) {  // this lane's column of tile, raw
    const int p = max(tile, 0) * T + min(lane, T - 1);
    return Col{a.orig[p], a.valid[p], tile >= 0 && lane < T};
  };
  auto last = [&](int q) { return q % sn == sn - 1; };
  auto issue = [&](int q) {  // the iteration's copies (every thread)
    const int tile = hdr_t[q % kHdr];
    if (tile < 0) return;
    float* st = stages + (size_t)(q % kStages) * P.stage_floats;
    const int sl = q % sn, k0 = sl * P.w, width = min(P.w, P.dp - k0);
    copy_rows(st, a.pts, tile * T, T, Lp, a.d, k0, width, P.sd, vec4);
    if (sn > 1) copy_rows(st + kMaxTile * P.sd, a.pts, x0, kRows, Lp, a.d, k0, width, P.sd, vec4);
  };
  auto gather = [&](int q, const Col& c) {  // the column attributes of iteration q (the gather warp)
    const int o = c.ok && c.v ? c.o : -1;
    const int at = (q % kStages) * kMaxTile + lane;
    ocol[at] = o;
    if (o >= 0) {
      cp_async8(labc + at, a.labels + o);
      cp_async4b(cdc + at, a.cd + o);
    }
  };
  // The gather warp's state entering iteration k: the header ring at the
  // visit in progress at iteration k + kAhead, and the raw columns of
  // iteration k + kAhead (col0).
  const bool gw = warp == kGatherWarp;
  Headers<kHdr> hdr(hdr_t, hdr_l, a.order + (size_t)blk * NT, a.lbs + (size_t)blk * NT, NT, rank, C, sn, lane);
  Col col0{0, false, false}, col1{0, false, false};

  // Prologue: headers of iterations 0 .. kAhead, gathers of 0 .. kAhead - 1,
  // the columns of kAhead, the raw visit of kAhead + 1; the first kAhead
  // iterations' copies, a commit group each.
  if (gw) {
    for (int q = 0; q <= kAhead; ++q) {
      hdr.prime(q);
      if (last(q)) {
        const Col c = load_col(hdr.cur_t);
        if (q < kAhead) gather(q, c);
        else col0 = c;
      }
    }
    hdr.fetch(kAhead + 1);
  }
  if (sn == 1) copy_rows(xs, a.pts, x0, kRows, Lp, a.d, 0, P.dp, P.sd, vec4);
  __syncthreads();
  for (int q = 0; q < kAhead; ++q) {
    issue(q);
    repro::cp_async_commit();
  }

  // The row: xx, its best (bw, be) and thr = sq_cap(bw), -inf for a dead
  // row (no sq passes).
  float bw = inf(), thr = live ? inf() : -inf();
  int be = INT_MAX;
  const float xx = row < Lp ? repro::dot_chain(a.pts + (size_t)p_row * a.d, a.pts + (size_t)p_row * a.d, a.d) : 0.f;
  float xr[kHeld ? DP : 1];       // the row's features (d <= 16), read from the staged rows once
  float acc[kMaxTile], yy = 0.f;  // column c's dot product; lane c: column c's squared norm
#pragma unroll
  for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
  int visited = 0;
  bool want = hdr_t[0] >= 0;
  for (int k = 0;; ++k) {
    if constexpr (kAhead > 0) cp_async_wait<(kAhead > 0 ? kAhead - 1 : 0)>();
    if (!__syncthreads_or(want)) break;
    issue(k + kAhead);
    if (gw) {
      const int q1 = k + kAhead + 1;
      hdr.step(q1);
      if (last(q1)) col1 = load_col(hdr.cur_t);
      hdr.fetch(q1 + 1);
    }
    if constexpr (kAhead == 0) {
      if (gw && last(k)) gather(k, col0);
      repro::cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int s = k % kStages;
    const float* st = stages + (size_t)s * P.stage_floats;
    const bool fin = last(k);
    if constexpr (kHeld) {
      if (k == 0) {  // the row's features, from the query rows staged in the prologue
#pragma unroll
        for (int f = 0; f < DP; f += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xs + tid * P.sd + f);
          xr[f] = v.x, xr[f + 1] = v.y, xr[f + 2] = v.z, xr[f + 3] = v.w;
        }
      }
    }
    // the slice's features: lane c chains column c's yy, every row its dot products
    const int width = DP > 0 ? DP : min(P.w, P.dp - (k % sn) * P.w);
    const float* yl = st + min(lane, kMaxTile - 1) * P.sd;
    const float* xrow = (sn > 1 ? st + kMaxTile * P.sd : xs) + tid * P.sd;
#pragma unroll 1
    for (int f0 = 0; f0 < width; f0 += KS) {
      float x[KS];
#pragma unroll
      for (int f = 0; f < KS; f += 4) {
        if constexpr (kHeld) {
          x[f] = xr[f], x[f + 1] = xr[f + 1], x[f + 2] = xr[f + 2], x[f + 3] = xr[f + 3];
        } else {
          const bool in = DP > 0 || f0 + f < width;
          const float4 v = in ? *reinterpret_cast<const float4*>(xrow + f0 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
          x[f] = v.x, x[f + 1] = v.y, x[f + 2] = v.z, x[f + 3] = v.w;
        }
      }
#pragma unroll
      for (int f = 0; f < KS; f += 4) {
        if (DP > 0 || f0 + f < width) {
          const float4 v = *reinterpret_cast<const float4*>(yl + f0 + f);
          yy = __fmaf_rn(v.x, v.x, yy);
          yy = __fmaf_rn(v.y, v.y, yy);
          yy = __fmaf_rn(v.z, v.z, yy);
          yy = __fmaf_rn(v.w, v.w, yy);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) {
        const float* y = st + c * P.sd + f0;
#pragma unroll
        for (int f = 0; f < KS; f += 4) {
          if (DP > 0 || f0 + f < width) {
            const float4 v = *reinterpret_cast<const float4*>(y + f);
            acc[c] = __fmaf_rn(x[f], v.x, acc[c]);
            acc[c] = __fmaf_rn(x[f + 1], v.y, acc[c]);
            acc[c] = __fmaf_rn(x[f + 2], v.z, acc[c]);
            acc[c] = __fmaf_rn(x[f + 3], v.w, acc[c]);
          }
        }
      }
    }
    if (fin) {
      const int* oc = ocol + s * kMaxTile;
      const long long* lc = labc + s * kMaxTile;
      const float* cc = cdc + s * kMaxTile;
      // Lane c hands its warp column c's (yy, cd_c^2 rounded down, cd_c,
      // o_c); yy is NaN where the column is invalid, which fails every
      // comparison.
      {
        const int o = lane < T ? oc[lane] : -1;
        const float cd_l = cc[lane];
        cval[lane] = make_float4(o >= 0 ? yy : nan_(), __fmul_rd(cd_l, cd_l), cd_l, __int_as_float(o));
        __syncwarp();
      }
      // Every column, no branch and no chain through the columns: the
      // tests sq <= thr, cd_c^2 rounded down <= thr (a larger one puts
      // cd_c above the row's best) and another label against thr at the
      // visit's start into a mask; where any row of the warp keeps a
      // column, the exact (w, eid) of every kept column into four running
      // lexicographic minima (columns c mod 4), merged into the row's best
      // once.
      unsigned keep = 0;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) {
        const float4 cv = cval[c];
        acc[c] = __fsub_rn(__fadd_rn(xx, cv.x), __fmul_rn(2.f, acc[c]));  // sq
        keep |= (acc[c] <= thr && cv.y <= thr && lc[c] != lab_r ? 1u : 0u) << c;
      }
      if (__any_sync(kFull, keep != 0)) {  // past a walk's first tiles, seldom
        float wq[4] = {inf(), inf(), inf(), inf()};
        int eq[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          const float4 cv = cval[c];
          const int o_c = __float_as_int(cv.w);
          const float w = fmaxf(sqrtf(fmaxf(acc[c], 0.f)), fmaxf(cd_r, cv.z));
          const int e = min(o_r, o_c) * Lp + max(o_r, o_c);
          const bool lt = (keep >> c & 1u) && (w < wq[c & 3] || (w == wq[c & 3] && e < eq[c & 3]));
          wq[c & 3] = lt ? w : wq[c & 3];
          eq[c & 3] = lt ? e : eq[c & 3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (wq[j] < bw || (wq[j] == bw && eq[j] < be)) {
            bw = wq[j];
            be = eq[j];
          }
        }
        thr = live ? sq_cap(bw) : -inf();
      }
      __syncwarp();  // the warp is done with cval before the next visit writes it
      yy = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
      visited += 1;
      const float nl = hdr_l[(k + 1) % kHdr];  // +inf: no next visit
      want = live && nl < inf() && fmaxf(nl, cd_r) <= bw;
    } else {
      want = true;
    }
    if constexpr (kAhead > 0) {
      if (gw && last(k + kAhead)) gather(k + kAhead, col0);
      repro::cp_async_commit();
    }
    col0 = col1;
  }
  repro::cp_async_wait_all();

  // Each row's (w, eid) across the cluster's CTAs.
  if (C == 1) {
    if (row < Lp) {
      a.w_out[row - a.block0 * kRows] = bw;
      a.eid_out[row - a.block0 * kRows] = be;
    }
  } else {
    fw[tid] = bw;
    fe[tid] = be;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int share = kRows / C;
    if (tid < share) {
      const int i = rank * share + tid;
      const Best b = cluster_min(cluster, fw, fe, i, C);
      if (x0 + i < Lp) {
        a.w_out[x0 + i - a.block0 * kRows] = b.v;
        a.eid_out[x0 + i - a.block0 * kRows] = b.e;
      }
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
  count_visits(a.visits, visited, min(kRows, Lp - x0));
}

}  // namespace

// The sorted table (pts (Lp, d) f32, orig (Lp,) int32, valid (Lp,) bool in
// NT tiles of T rows), its query blocks [block0, block0 + nblocks) of 64
// rows with their visit lists order (ceil(Lp / 64), NT) int32 and lbs f32;
// cd (Lp,) f32, labels (Lp,) int64 and hopeless (Lp,) bool in original
// order; cluster C in {1, 2, 4, 8}: CTAs a query block; w_out
// (nblocks * 64,) f32 and eid_out (nblocks * 64,) int32: the blocks' rows in
// sorted order; visits: null or two 64-bit counters (rows x tiles visited,
// added; the longest walk of a CTA, a maximum).  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_grid_round_tiles_f32(const void* pts, const void* orig, const void* valid, int Lp, int d, int T,
                                          const void* order, const void* lbs, int NT, const void* cd,
                                          const void* labels, const void* hopeless, int block0, int nblocks,
                                          int cluster, void* w_out, void* eid_out, void* visits, void* stream) {
  if (bad_grid(Lp, d, T, NT) || bad_blocks(Lp, block0, nblocks) || !good_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const int DP = width_for(d);
  const Plan P(d, DP);
  void (*kernel)(const Args, int) = DP == 16    ? grid_round_tiles_kernel<16>
                                    : DP == 32  ? grid_round_tiles_kernel<32>
                                    : DP == 64  ? grid_round_tiles_kernel<64>
                                    : DP == 128 ? grid_round_tiles_kernel<128>
                                                : grid_round_tiles_kernel<0>;
  const Args args{static_cast<const float*>(pts), static_cast<const int*>(orig), static_cast<const bool*>(valid),
                  Lp, d, T, static_cast<const int*>(order), static_cast<const float*>(lbs), NT,
                  static_cast<const float*>(cd), static_cast<const long long*>(labels),
                  static_cast<const bool*>(hopeless), block0, static_cast<float*>(w_out),
                  static_cast<int*>(eid_out), static_cast<unsigned long long*>(visits)};
  return launch_clusters(kernel, args, nblocks, cluster, P.bytes, stream);
}
