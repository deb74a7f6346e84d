// The spatial index's nearest-rep search redesigned for Hopper (plain C
// interface, sm_90a): per query row of the Morton-sorted queries, the
// lexicographic minimum of (expanded_sq, ORIGINAL index) over the VALID
// rows of the sorted table; idx = Lp where the table has none, dist the
// correctly rounded sqrtf of the minimum.  It replaces the JAX package's
// jnp program repro/kernels/grid.py::grid_assign (:355) on every path
// (kernels/grid.py::grid_assign: the engine's ingest, the serve plane's
// query, device-online ingest, the spatial router); no Pallas kernel stands
// behind it.  The first kernel, csrc/grid.cu's grid_assign_kernel, stays as
// its bitwise oracle (grid_assign_v1) and runs on no path.
//
// What held the first kernel: one CTA of 256 threads per 64 query rows (128
// CTAs at 8192 queries, 64 at 4096 on 132 SMs), one tile in flight (staged
// behind a barrier each visit), the dependent loads valid[p] -> orig[p]
// after the FMAs, and eight warp reductions a visit for the stop vote.  At
// the ingest shape a block walks ~88 of 256 tiles, and the launch's time is
// its longest walk.  Bound on the H100: operations, 2·d FLOPs per (row,
// visited column).
//
// The design (csrc/grid_round.cu's, where assign is simpler; the sizes,
// the ring's geometry and copies, the header ring, the cluster's merge and
// launch are grid_tiles.cuh's, shared with it):
//  * The walk is split across a thread-block cluster of C CTAs per 64-row
//    block (cudaLaunchKernelEx with a cluster dimension; kernels/grid.py
//    launches ASSIGN_CLUSTER): rank r visits positions r, r + C, r + 2C, ...
//    of the block's order.  Each CTA stops at the first visit whose bound is
//    strictly above every live row's best in the cluster: each CTA publishes
//    its rows' bests in its shared memory after every merge, and a CTA whose
//    own bests would go on reads its peers' through distributed shared
//    memory, without a barrier.  Any published value is a real candidate, at
//    least the row's final answer, and the bounds ascend, so the stop is
//    exact (ties are visited), and the cluster visits about the tiles one
//    CTA would (a stop on each CTA's own bests visited 26 % more at the
//    ingest shape).  The same value bounds the row's candidate filter: a
//    column above it cannot be the row's answer.  At the end the C partial (sq, orig) per row merge
//    through distributed shared memory in lexicographic order, which is
//    order-free: the bits do not depend on C.  At C = 1 the stop is the
//    first kernel's, visit for visit.
//  * A thread owns a query row: its features in registers (d <= 16; wider d
//    8 at a time from shared memory, beside the 32 dot products in
//    registers at <= 128 a thread), its best (sq, orig).  It sweeps the
//    tile's 32 columns, whose features every lane reads by broadcast, one
//    ascending FMA chain each.  No per-row state is replicated across lanes
//    and no warp reduction runs a visit: the stop vote is one
//    __syncthreads_or over the CTA's 2 warps (64 rows).  Rows past n in the
//    ragged last block are not live: they vote no, write nothing and add
//    nothing to the visit count.
//  * A ring of S stages in shared memory, filled kAhead = S - 1 visits
//    ahead by 16-byte cp.async copies (4-byte where d % 4 != 0 or the pointer
//    is not 16-byte aligned).  A stage holds a tile's 32 rows (past one slice
//    of kSlice features, a slice of them and of the block's 64 query rows),
//    row stride sd = w | 4 floats, and the tile's column attributes: orig[p]
//    and valid[p] of a tile are contiguous in the sorted table, so they ride
//    the same commit group as its rows (orig 4 bytes a column; valid as the
//    aligned 4-byte words that hold the tile's bytes: a copy never leaves its
//    aligned word, so never the allocation).  The tile and bound of each
//    visit reach the block through a small header ring a visit before its
//    copies.  Copies fetched past the stop point are dropped.
//  * Every column of a visit, with no branch and no chain through the
//    columns: valid and sq <= the row's best in the cluster at the visit's
//    start (ties kept) into a mask, an invalid column's yy NaN, which fails the test;
//    then, only in a visit where a row of the warp keeps a column, the kept
//    (sq, orig) into four running lexicographic minima, merged into the
//    row's best once.
//
// Bits: xx is common.cuh's dot_chain of the row; every acc and yy is one
// ascending __fmaf_rn chain over the features (zero-padded to the compiled
// width 16, 32, 64 or 128, which leaves the bits alone: a chain from +0
// never holds -0), continued slice by slice past 128 features, so any d
// runs; sq is common.cuh's expanded_sq and dist the correctly rounded
// sqrtf, as the first kernel and the dense assign kernel (assign_ws.cu)
// compute them; no tensor cores, no TF32.  Ties merge on (sq, orig).
//
// python -m repro_torch.kernels.grid_variants times other ring depths, the
// cluster size (an argument), and variants it patches into this source: a
// stop on each CTA's own bests, the filter on them, 6 CTAs an SM, and a
// probe of where the time goes.
#include "grid_tiles.cuh"

namespace {

using namespace repro::tiles;

constexpr int kStages = 4;  // ring depth S: visits in flight = S - 1

constexpr int kAhead = kStages - 1;
constexpr int kHdr = kAhead + 2;  // header ring: written a visit before the copies, read up to kAhead after
constexpr int kVWords = kMaxTile / 4 + 1;  // aligned 4-byte words that hold a tile's valid bytes
constexpr int kSub = 16;         // the row's features held in registers (d <= 16)
constexpr int kSubShared = 8;    // features a register slice of a row read from shared memory (d > 16)
constexpr int kHdrWarp = kWarps - 1;

static_assert(kStages >= 1 && kAhead + 2 <= 32, "ring depth");

// Shared-memory plan: the ring (grid_tiles.cuh's Slices), then the offsets
// (bytes) of this kernel's regions.
struct Plan : Slices {
  size_t ocol, vcol, hdr_t, hdr_l, fs, fi, cval, bytes;
  __host__ __device__ Plan(int d_, int DP) : Slices(d_, DP, kStages) {
    size_t at = end;
    ocol = at;
    at += sizeof(int) * kStages * kMaxTile;
    vcol = at;
    at += sizeof(unsigned) * kStages * kVWords;
    hdr_t = at;
    at += sizeof(int) * kHdr;
    hdr_l = at;
    at += sizeof(float) * kHdr;
    fs = at;
    at += sizeof(float) * kRows;
    fi = at;
    at += sizeof(int) * kRows;
    cval = at = (at + 15) & ~size_t(15);
    at += sizeof(float2) * kWarps * kMaxTile;
    bytes = (at + 15) & ~size_t(15);
  }
};

struct Args {
  const float* x;
  int n;
  const float* pts;
  const int* orig;
  const bool* valid;
  int Lp, d, T;
  const int* order;
  const float* lbs;
  int NT;
  int* idx_out;
  float* dist_out;
  unsigned long long* visits;  // null, or [rows x tiles visited, the longest walk of a CTA]
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 8)
grid_assign_tiles_kernel(const Args a, int C) {
  constexpr bool kHeld = DP > 0 && DP <= kSub;      // the row's features stay in registers
  constexpr int KS = kHeld ? DP : kSubShared;        // features a register slice
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan P(a.d, DP);
  float* xs = reinterpret_cast<float*>(smem + P.xs);
  float* stages = reinterpret_cast<float*>(smem + P.stages);
  int* ocol = reinterpret_cast<int*>(smem + P.ocol);
  unsigned* vcol = reinterpret_cast<unsigned*>(smem + P.vcol);
  int* hdr_t = reinterpret_cast<int*>(smem + P.hdr_t);
  float* hdr_l = reinterpret_cast<float*>(smem + P.hdr_l);
  float* fs = reinterpret_cast<float*>(smem + P.fs);
  int* fi = reinterpret_cast<int*>(smem + P.fi);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float2* cval = reinterpret_cast<float2*>(smem + P.cval) + warp * kMaxTile;  // this warp's copy
  const int rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const int blk = static_cast<int>(blockIdx.x) / C;
  const int x0 = blk * kRows, row = x0 + tid, n = a.n;
  const bool live = row < n;
  const int Lp = a.Lp, T = a.T, NT = a.NT, sn = DP > 0 ? 1 : P.sn;
  const bool vec4x = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool vec4y = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.pts) % 16 == 0;
  const uintptr_t vbase = reinterpret_cast<uintptr_t>(a.valid);

  // Iteration q: visit q / sn, feature slice q % sn.
  auto last = [&](int q) { return q % sn == sn - 1; };
  auto issue = [&](int q) {  // the iteration's copies (every thread)
    const int tile = hdr_t[q % kHdr];
    if (tile < 0) return;
    const int s = q % kStages;
    float* st = stages + (size_t)s * P.stage_floats;
    const int sl = q % sn, k0 = sl * P.w, width = min(P.w, P.dp - k0);
    copy_rows(st, a.pts, tile * T, T, Lp, a.d, k0, width, P.sd, vec4y);
    if (sn > 1) copy_rows(st + kMaxTile * P.sd, a.x, x0, kRows, n, a.d, k0, width, P.sd, vec4x);
    if (last(q)) {  // the tile's column attributes, for the visit's candidates
      const int p0 = tile * T;
      if (tid < T) cp_async4b(ocol + s * kMaxTile + tid, a.orig + p0 + tid);
      const uintptr_t w0 = (vbase + p0) & ~uintptr_t(3);
      const int words = static_cast<int>((((vbase + p0 + T - 1) & ~uintptr_t(3)) - w0) / 4) + 1;
      const int j = tid - (kThreads - kVWords);
      if (j >= 0 && j < words) cp_async4b(vcol + s * kVWords + j, reinterpret_cast<const void*>(w0 + 4 * j));
    }
  };
  // The header warp's ring, entering iteration k at the visit in progress
  // at iteration k + kAhead.
  const bool hw = warp == kHdrWarp;
  Headers<kHdr> hdr(hdr_t, hdr_l, a.order + (size_t)blk * NT, a.lbs + (size_t)blk * NT, NT, rank, C, sn, lane);

  // Prologue: headers of iterations 0 .. kAhead, the raw visit of kAhead +
  // 1; the first kAhead iterations' copies, a commit group each.
  if (hw) {
    for (int q = 0; q <= kAhead; ++q) hdr.prime(q);
    hdr.fetch(kAhead + 1);
  }
  if (sn == 1) copy_rows(xs, a.x, x0, kRows, n, a.d, 0, P.dp, P.sd, vec4x);
  __syncthreads();
  for (int q = 0; q < kAhead; ++q) {
    issue(q);
    repro::cp_async_commit();
  }

  // The row: xx and its best (bs, bi); thr the filter, the row's best in the
  // cluster at a visit's start, -inf for a row past n (no column passes).
  float bs = inf(), thr = live ? inf() : -inf();
  int bi = INT_MAX;
  const float xx = live ? repro::dot_chain(a.x + (size_t)row * a.d, a.x + (size_t)row * a.d, a.d) : 0.f;
  float xr[kHeld ? DP : 1];       // the row's features (d <= 16), read from the staged rows once
  float acc[kMaxTile], yy = 0.f;  // column c's dot product; lane c: column c's squared norm
#pragma unroll
  for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
  // The cluster's bests of this thread's row: published in fs after every
  // merge; a peer reads them without a barrier.
  cg::cluster_group cluster = cg::this_cluster();
  fs[tid] = inf();
  if (C > 1) cluster.sync();  // every CTA's published bests set before a peer reads them
  auto cluster_best = [&](float b) {  // the least of b and the peers' published bests
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C && r != rank) b = fminf(b, peer_best(fs + tid, r));
    }
    return b;
  };
  int visited = 0;
  bool want = hdr_t[0] >= 0;
  for (int k = 0;; ++k) {
    if constexpr (kAhead > 0) cp_async_wait<(kAhead > 0 ? kAhead - 1 : 0)>();
    if (!__syncthreads_or(want)) break;
    issue(k + kAhead);
    if (hw) {
      hdr.step(k + kAhead + 1);
      hdr.fetch(k + kAhead + 2);
    }
    if constexpr (kAhead == 0) {
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
      // Lane c hands its warp column c's (yy, orig); yy is NaN where the
      // column is invalid or past the tile, which fails every comparison.
      {
        const int tile = hdr_t[k % kHdr];
        const unsigned char* vb = reinterpret_cast<const unsigned char*>(vcol + s * kVWords) +
                                  ((vbase + (uintptr_t)tile * T) & 3);
        const bool ok = lane < T && vb[min(lane, kMaxTile - 1)];
        const int o = ok ? ocol[s * kMaxTile + lane] : -1;
        cval[lane] = make_float2(ok ? yy : nan_(), __int_as_float(o));
        __syncwarp();
      }
      // Every column, no branch and no chain through the columns: sq <= the
      // row's best at the visit's start (ties kept) into a mask; where any
      // row of the warp keeps a column, the (sq, orig) of every kept column
      // into four running lexicographic minima (columns c mod 4), merged
      // into the row's best once.
      unsigned keep = 0;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) {
        acc[c] = __fsub_rn(__fadd_rn(xx, cval[c].x), __fmul_rn(2.f, acc[c]));  // sq before the clamp
        keep |= (acc[c] <= thr ? 1u : 0u) << c;
      }
      if (__any_sync(kFull, keep != 0)) {  // past a walk's first tiles, seldom
        float sq4[4] = {inf(), inf(), inf(), inf()};
        int i4[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          const int o_c = __float_as_int(cval[c].y);
          const float sq = fmaxf(acc[c], 0.f);  // common.cuh's expanded_sq
          const bool lt = (keep >> c & 1u) && (sq < sq4[c & 3] || (sq == sq4[c & 3] && o_c < i4[c & 3]));
          sq4[c & 3] = lt ? sq : sq4[c & 3];
          i4[c & 3] = lt ? o_c : i4[c & 3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (sq4[j] < bs || (sq4[j] == bs && i4[j] < bi)) {
            bs = sq4[j];
            bi = i4[j];
          }
        }
        thr = live ? bs : -inf();
        *reinterpret_cast<volatile float*>(fs + tid) = bs;
      }
      __syncwarp();  // the warp is done with cval before the next visit writes it
      yy = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
      visited += 1;
      const float nl = hdr_l[(k + 1) % kHdr];  // +inf: no next visit
      want = live && nl < inf() && nl <= bs;
      if (C > 1 && want) {  // the cluster's best: the stop, and the filter of the next visits
        const float cb = cluster_best(bs);
        want = nl <= cb;
        thr = cb;
      }
    } else {
      want = true;
    }
    if constexpr (kAhead > 0) repro::cp_async_commit();
  }
  repro::cp_async_wait_all();

  // Each row's (sq, orig) across the cluster's CTAs.
  if (C == 1) {
    if (live) {
      a.idx_out[row] = bi == INT_MAX ? Lp : bi;
      a.dist_out[row] = sqrtf(bs);
    }
  } else {
    fs[tid] = bs;
    fi[tid] = bi;
    cluster.sync();
    const int share = kRows / C;
    if (tid < share) {
      const int i = rank * share + tid;
      const Best b = cluster_min(cluster, fs, fi, i, C);
      if (x0 + i < n) {
        a.idx_out[x0 + i] = b.e == INT_MAX ? Lp : b.e;
        a.dist_out[x0 + i] = sqrtf(b.v);
      }
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
  count_visits(a.visits, visited, min(kRows, n - x0));
}

}  // namespace

// x (n, d) Morton-sorted queries; pts (Lp, d), orig (Lp,) int32, valid (Lp,)
// bool: the sorted table in NT tiles of T rows; order (ceil(n / 64), NT)
// int32 and lbs (ceil(n / 64), NT) f32 each block's tiles by ascending
// lb_sq - slack; cluster C in {1, 2, 4, 8}: CTAs a query block; idx_out
// (n,) int32, dist_out (n,) f32 in sorted order; visits: null or two 64-bit
// counters (rows x tiles visited, added; the longest walk of a CTA, a
// maximum).  Returns cudaGetLastError() after the launch.
extern "C" int repro_grid_assign_tiles_f32(const void* x, int n, const void* pts, const void* orig, const void* valid,
                                           int Lp, int d, int T, const void* order, const void* lbs, int NT,
                                           int cluster, void* idx_out, void* dist_out, void* visits, void* stream) {
  if (n <= 0 || bad_grid(Lp, d, T, NT) || !good_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  const int DP = width_for(d);
  const Plan P(d, DP);
  void (*kernel)(const Args, int) = DP == 16    ? grid_assign_tiles_kernel<16>
                                    : DP == 32  ? grid_assign_tiles_kernel<32>
                                    : DP == 64  ? grid_assign_tiles_kernel<64>
                                    : DP == 128 ? grid_assign_tiles_kernel<128>
                                                : grid_assign_tiles_kernel<0>;
  const Args args{static_cast<const float*>(x), n, static_cast<const float*>(pts), static_cast<const int*>(orig),
                  static_cast<const bool*>(valid), Lp, d, T, static_cast<const int*>(order),
                  static_cast<const float*>(lbs), NT, static_cast<int*>(idx_out), static_cast<float*>(dist_out),
                  static_cast<unsigned long long*>(visits)};
  return launch_clusters(kernel, args, (n + kRows - 1) / kRows, cluster, P.bytes, stream);
}
