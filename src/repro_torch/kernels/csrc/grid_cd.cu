// The spatial index's Eq. 6 search redesigned for Hopper (plain C interface,
// sm_90a): per valid row of the Morton-sorted table, the first k =
// min(min_pts, Lp) entries of its (distance, ORIGINAL index) order over the
// valid rows -- the row itself at exactly 0 -- then bubble_cd_ws.cu's walk:
// the masses added one __fadd_rn at a time in that order up to the min_pts
// crossing, and common.cuh's Eq. 6 (below min_pts, the last entry plays the
// crossing bubble); 0 on invalid rows.  It replaces the JAX package's jnp
// program repro/kernels/grid.py::grid_core_distances (:222,
// _cd_block_values :255) on every path (kernels/grid.py::grid_core_distances:
// the offline pass, the sharded pass's block ranges, the kernel API); no
// Pallas kernel stands behind it.  The first kernel, csrc/grid.cu's
// grid_cd_kernel, stays as its bitwise oracle (grid_core_distances_v1) and
// runs on no path.
//
// What held the first kernel: one CTA of 256 threads per 64 query rows (128
// CTAs at Lp = 8192 on 132 SMs), each walking its block's tiles one at a
// time behind a barrier, with the dependent loads valid[p] -> orig[p] and a
// vote each visit, for 8 rows x d FMAs a thread.  Its stop ran on a row's
// queued k-th, which moves only when a thread queue fills and merges, so it
// walked further than the answer needs; and past k = 64 it re-walked the
// whole list once a pass of fewer rows a warp.
//
// The design (the sizes, the ring's geometry and copies, the header ring and
// the cluster launch are grid_tiles.cuh's, shared with grid_round.cu and
// grid_assign.cu):
//  * The walk is split across a thread-block cluster of C CTAs per 64-row
//    block (kernels/grid.py launches CD_CLUSTER): rank r visits positions r,
//    r + C, r + 2C, ... of the block's order.
//  * The register route stops on the cluster's k-th bounds.  A CTA's k-th over its own tiles
//    is never below the row's true k-th, so any CTA's full list bounds the
//    row's answer.  But a CTA holds about a C-th of the row's near keys, so
//    its own k-th is near the row's (C·k)-th: each CTA also publishes its
//    j-th, j = ceil(k / C), and since the C lists hold distinct keys, the
//    largest j-th over the cluster has at least k keys at or below it.  The
//    bound is the least of the cluster's k-th and that largest j-th.  Each
//    CTA publishes both in its shared memory (+inf until its list holds
//    them, then only lowered); every visit each CTA reads its peers' through
//    distributed shared memory, issued before the visit's FMAs and used at
//    its vote, without a barrier: a stale value is only larger, so the stop
//    stays exact (a bound equal to the k-th is visited).
//  * k <= kRegK: a thread a row (64 threads a CTA).  Its features in
//    registers (d <= 16; wider d 8 at a time from shared memory), 32 dot
//    products in registers, its first k keys (distance bits, original
//    index) as a sorted register list of KC = 12 (k <= 12) or 16 slots kept
//    by a predicated compare and shift, whose k-th is exact after every
//    visit.  The tiles come through a ring of kStages stages filled by
//    cp.async copies kStages - 1 visits ahead, the tile's orig and valid in
//    the same commit group; a visit's columns pass a filter, the square cap
//    of the successor of the row's bound at the visit's start (a larger
//    square has a root above it), into a mask, and only the kept columns
//    take the exact key test, each thread looping over its own kept columns
//    (their squares staged in shared memory), so a warp pays for its
//    busiest row, not for every column any row keeps.  At the end the C
//    sorted lists of a row merge in (distance, index) order -- keys are
//    unique, a tile being visited by one CTA -- gathered through
//    distributed shared memory into the ring's bytes, and the row's thread
//    walks the masses.
//  * k > kRegK: the first kernel's warp-select layout (warp_select.cuh
//    queues, R rows a warp, kPasses passes over the block's rows, rounds of
//    1024 keys above the last one taken past k = 1024; one tile in flight
//    behind a barrier).  Its 256-thread CTAs at 200-255 registers fit one an
//    SM, so the first kernel's 82 live blocks left 50 SMs idle, and a walk
//    split C ways paid merges and visits for a gain the card could not give.
//    A block's CTAs take the passes first: G = min(C, kPasses) groups, each
//    its share of the passes with no merge (a CTA a pass from k = 512 on);
//    each group's W = min(C / G, kWsSplit) CTAs, a cluster, split its walk
//    (so this route runs G·W <= C CTAs a block: past two, a split walk lost
//    more to the merges and the looser stop than the card had idle SMs to
//    give it), each CTA stopping on its own k-th: at W = 2 reading the
//    peer's bounds every visit cost more than the visits it saved
//    (grid_variants cd).  Where W > 1, each pass (and round) the group's
//    CTAs write their rows' selected keys to shared memory (at most 64 KB
//    at any K); the owner of a warp's rows, CTA warp % W, folds its peers'
//    sorted lists into its queue by bitonic merges, walks the masses, and
//    broadcasts whether each row goes on and the last key taken to the
//    cluster for the next round.  The layout's staging, visit, queue
//    shape, offers and walk are grid_ws.cuh's, shared with csrc/grid.cu.
//
// Bits: xx is common.cuh's dot_chain of the row; every acc and yy is one
// ascending __fmaf_rn chain over the features (zero-padded, which leaves the
// bits alone), continued slice by slice past 128 features, so any d runs; a
// distance is the correctly rounded sqrtf of expanded_sq, as the first
// kernel and the dense Eq. 6 kernels compute it; no tensor cores, no TF32.
// The first k keys of a row do not depend on C, nor on the route.
//
// python -m repro_torch.kernels.grid_variants cd times other ring depths, the
// cluster size (an argument), and variants it patches into this source: the
// stops, the warp-select route's split and stop, the register lists' sizes,
// the warp-select route at every k, and probes of where the time goes.
#include "grid_tiles.cuh"
#include "grid_ws.cuh"
#include "warp_select.cuh"

namespace {

using namespace repro::tiles;
namespace gw = repro::grid_ws;
namespace ws = repro::ws;
using gw::Walk;
using ws::Key;
using ws::kEmpty;

constexpr int kRegK = 16;      // the largest k of the register route (a row's first k keys in registers)
constexpr int kRegSmall = 12;  // up to this k the list takes 12 slots, not kRegK: each slot costs every insert
constexpr int kWsSplit = 2;  // the most CTAs the warp-select route splits a walk over

struct Args {
  const float* pts;
  const int* orig;
  const bool* valid;
  int Lp, d, T;
  const int* order;
  const float* lbs;
  int NT;
  const float* nb;
  const float* ext;
  int k, min_pts, dim, block0;
  int cta;  // C, CTAs a query block
  float* out;
  unsigned long long* visits;  // null, or [rows x tiles visited, the longest walk of a CTA]
};

// The distance of a k-th key, +inf for kEmpty.
__device__ __forceinline__ float kth_dist(Key k) { return k == kEmpty ? inf() : ws::key_dist(k); }

// ------------------------------------------- k <= kRegK: a thread a row
constexpr int kStages = 4;  // ring depth S: visits in flight = S - 1

constexpr int kAhead = kStages - 1;
constexpr int kHdr = kAhead + 2;  // header ring: written a visit before the copies, read up to kAhead after
constexpr int kVWords = kMaxTile / 4 + 1;  // aligned 4-byte words that hold a tile's valid bytes
constexpr int kSub = 16;         // the row's features held in registers (d <= 16)
constexpr int kSubShared = 8;    // features a register slice of a row read from shared memory (d > 16)
constexpr int kHdrWarp = kWarps - 1;

static_assert(kStages >= 1 && kAhead + 2 <= 32, "ring depth");

// Shared-memory plan: the ring (grid_tiles.cuh's Slices), whose bytes the
// merge takes after the walk (the CTA's lists, the lists it gathers from the
// cluster), then the offsets (bytes) of this route's regions.
template <int KC>
struct RegPlan : Slices {
  size_t lists, gath, ocol, vcol, hdr_t, hdr_l, fs, fj, sqs, cval, bytes;
  __host__ __device__ RegPlan(int d_, int DP) : Slices(d_, DP, kStages) {
    const size_t keys = sizeof(Key) * kRows * KC;
    lists = 0;
    gath = keys;
    size_t at = end > 2 * keys ? end : 2 * keys;
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
    fj = at;
    at += sizeof(float) * kRows;

    sqs = at;
    at += sizeof(float) * kMaxTile * kRows;
    cval = at = (at + 15) & ~size_t(15);
    at += sizeof(float2) * kWarps * kMaxTile;
    bytes = (at + 15) & ~size_t(15);
  }
};

// The distance of L[i] for a runtime i: a select over the slots.
template <int KC>
__device__ __forceinline__ float dist_at(const Key (&L)[KC], int i) {
  Key v = kEmpty;
#pragma unroll
  for (int s = 0; s < KC; ++s) v = s == i ? L[s] : v;
  return kth_dist(v);
}

// A row's first keys as a register list, descending: L[0] the k-th (kEmpty
// until k are held), the keys in L[0 .. k-1], then a floor of zero keys that
// stays below them.  x enters where it is below L[0]: a compare and shift,
// predicated, each slot from the old L[i] and L[i + 1].
template <int KC>
__device__ __forceinline__ void take_key(Key (&L)[KC], Key x) {
  if (x < L[0]) {
#pragma unroll
    for (int i = 0; i < KC - 1; ++i) L[i] = L[i + 1] > x ? L[i + 1] : (L[i] > x ? x : L[i]);
    L[KC - 1] = L[KC - 1] > x ? x : L[KC - 1];
  }
}

template <int DP, int KC>
__global__ void __launch_bounds__(kThreads, 8)
grid_cd_reg_kernel(const Args a, int C) {
  constexpr bool kHeld = DP > 0 && DP <= kSub;      // the row's features stay in registers
  constexpr int KS = kHeld ? DP : kSubShared;        // features a register slice
  extern __shared__ __align__(16) unsigned char smem[];
  const RegPlan<KC> P(a.d, DP);
  float* xs = reinterpret_cast<float*>(smem + P.xs);
  float* stages = reinterpret_cast<float*>(smem + P.stages);
  int* ocol = reinterpret_cast<int*>(smem + P.ocol);
  unsigned* vcol = reinterpret_cast<unsigned*>(smem + P.vcol);
  int* hdr_t = reinterpret_cast<int*>(smem + P.hdr_t);
  float* hdr_l = reinterpret_cast<float*>(smem + P.hdr_l);
  float* fs = reinterpret_cast<float*>(smem + P.fs);
  float* fj = reinterpret_cast<float*>(smem + P.fj);
  float* sqs = reinterpret_cast<float*>(smem + P.sqs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float2* cval = reinterpret_cast<float2*>(smem + P.cval) + warp * kMaxTile;  // this warp's copy
  const int rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const int blk = a.block0 + static_cast<int>(blockIdx.x) / C;
  const int x0 = blk * kRows, row = x0 + tid;
  const int Lp = a.Lp, T = a.T, NT = a.NT, sn = DP > 0 ? 1 : P.sn, nk = a.k;
  const int jr = (nk + C - 1) / C;  // the rank each CTA publishes besides the k-th
  const float mp = static_cast<float>(a.min_pts);
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.pts) % 16 == 0;
  const uintptr_t vbase = reinterpret_cast<uintptr_t>(a.valid);

  // The block's rows first: a block with no valid row writes its zeros and
  // leaves (the padding's blocks).
  const int p_row = min(row, Lp - 1);
  const bool live = row < Lp && a.valid[p_row];
  const int o_r = a.orig[p_row];
  if (!__syncthreads_or(live)) {
    if (rank == 0 && row < Lp) a.out[row - a.block0 * kRows] = 0.f;
    return;
  }

  // Iteration q: visit q / sn, feature slice q % sn.
  auto last = [&](int q) { return q % sn == sn - 1; };
  auto issue = [&](int q) {  // the iteration's copies (every thread)
    const int tile = hdr_t[q % kHdr];
    if (tile < 0) return;
    const int s = q % kStages;
    float* st = stages + (size_t)s * P.stage_floats;
    const int sl = q % sn, k0 = sl * P.w, width = min(P.w, P.dp - k0);
    copy_rows(st, a.pts, tile * T, T, Lp, a.d, k0, width, P.sd, vec4);
    if (sn > 1) copy_rows(st + kMaxTile * P.sd, a.pts, x0, kRows, Lp, a.d, k0, width, P.sd, vec4);
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
  if (sn == 1) copy_rows(xs, a.pts, x0, kRows, Lp, a.d, 0, P.dp, P.sd, vec4);
  __syncthreads();
  for (int q = 0; q < kAhead; ++q) {
    issue(q);
    repro::cp_async_commit();
  }

  // The row: xx, its list L, its k-th and jr-th distances kd, jd; thr the
  // filter, the square cap of the row's bound in the cluster at a visit's
  // start, -inf for a row that is not live (no column passes).
  Key L[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) L[i] = i < nk ? kEmpty : 0ull;
  float kd = inf(), jd = inf(), thr = live ? inf() : -inf();
  const float xx = live ? repro::dot_chain(a.pts + (size_t)row * a.d, a.pts + (size_t)row * a.d, a.d) : 0.f;
  float xr[kHeld ? DP : 1];       // the row's features (d <= 16), read from the staged rows once
  float acc[kMaxTile], yy = 0.f;  // column c's dot product; lane c: column c's squared norm
#pragma unroll
  for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
  // The cluster's bound of this thread's row: each CTA's k-th and jr-th
  // published in its fs, fj after every change; a peer reads them without a
  // barrier.  pk, pj: the peers' least k-th and largest jr-th, read at a
  // visit's start.
  cg::cluster_group cluster = cg::this_cluster();
  fs[tid] = inf();
  fj[tid] = inf();
  if (C > 1) cluster.sync();  // every CTA's published values set before a peer reads them
  float pk = inf(), pj = 0.f;
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
    if (C > 1 && live && last(k)) {  // the peers' bounds for this visit's vote: every load issued, then reduced
      float vk[kMaxCluster], vj[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const bool rd = r < C && r != rank;
        vk[r] = rd ? peer_best(fs + tid, r) : inf();
        vj[r] = rd ? peer_best(fj + tid, r) : 0.f;
      }
      pk = inf();
      pj = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        pk = fminf(pk, vk[r]);
        pj = fmaxf(pj, vj[r]);
      }
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
      // Every column, no branch and no chain through the columns: the
      // square (the row itself exactly 0) <= thr into a mask; a row that
      // keeps any stages its squares and takes its kept columns' keys (the
      // root of the clamped square, orig) into its list one by one, each
      // first against the cap of its list's k-th so far.
      unsigned keep = 0;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) {
        const float2 cv = cval[c];
        const float tt = __fsub_rn(__fadd_rn(xx, cv.x), __fmul_rn(2.f, acc[c]));  // sq before the clamp
        acc[c] = __float_as_int(cv.y) == o_r ? 0.f : tt;
        keep |= (acc[c] <= thr ? 1u : 0u) << c;
      }
      if (keep != 0) {  // past a walk's first tiles, seldom
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) sqs[c * kRows + tid] = acc[c];
        float cap = thr;
        do {
          const int c = __ffs(keep) - 1;
          keep &= keep - 1;
          const float sq = sqs[c * kRows + tid];
          if (sq <= cap) {
            take_key(L, ws::make_key(sqrtf(fmaxf(sq, 0.f)), __float_as_int(cval[c].y)));
            cap = fminf(cap, sq_cap(kth_dist(L[0])));
          }
        } while (keep != 0);
        kd = kth_dist(L[0]);
        jd = dist_at(L, nk - jr);
        thr = sq_cap(kd);
        *reinterpret_cast<volatile float*>(fs + tid) = kd;
        *reinterpret_cast<volatile float*>(fj + tid) = jd;
      }
      __syncwarp();  // the warp is done with cval before the next visit writes it
      yy = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxTile; ++c) acc[c] = 0.f;
      visited += 1;
      const float nl = hdr_l[(k + 1) % kHdr];  // +inf: no next visit
      want = live && nl < inf() && nl <= kd;
      if (C > 1 && want) {  // the cluster's k-th: the stop, and the filter of the next visits
        const float cb = fminf(fminf(kd, pk), fmaxf(jd, pj));
        want = nl <= cb;
        thr = sq_cap(cb);
      }
    } else {
      want = true;
    }
    if constexpr (kAhead > 0) repro::cp_async_commit();
  }
  repro::cp_async_wait_all();

  // Each row's first k keys over the cluster: every CTA's lists (slot j of
  // row i at lists[j * kRows + i]) into the ring's bytes; rank r gathers the
  // C lists of its share of the rows (list c's slot j of its row i at
  // gath[(j * C + c) * share + i]) and merges them.  At C = 1 the lists are
  // that layout already.
  __syncthreads();  // every copy into the ring has landed: its bytes are the lists'
  Key* lists = reinterpret_cast<Key*>(smem + P.lists);
  Key* gath = reinterpret_cast<Key*>(smem + P.gath);
#pragma unroll
  for (int i = 0; i < KC; ++i) lists[i * kRows + tid] = L[i];
  const int share = kRows / C;
  if (C > 1) {
    cluster.sync();  // every CTA's lists written
    for (int t = tid; t < share * C * KC; t += kThreads) {
      const int i = t % share, c = (t / share) % C, j = t / (share * C);
      gath[t] = *cluster.map_shared_rank(lists + j * kRows + rank * share + i, c);
    }
    cluster.sync();  // every peer's lists read: no CTA reads another's shared memory again
  } else {
    __syncthreads();
  }
  if (tid < share) {
    const int i = rank * share + tid, p = x0 + i;
    const Key* g = (C == 1 ? lists : gath) + tid;  // list c's slot j at g[(j * C + c) * share]
    float v = 0.f;
    if (p < Lp && a.valid[p]) {
      // The C lists ascend from slot k - 1 down: the first k of their union
      // in order, a head a list.
      Key h[kMaxCluster];
      int at[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        at[c] = nk - 1;
        h[c] = c < C ? g[((nk - 1) * C + c) * share] : kEmpty;
      }
      Key m[KC];
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        Key best = kEmpty;
        int bc = 0;
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (h[c] < best) {
            best = h[c];
            bc = c;
          }
        }
        m[e] = e < nk ? best : kEmpty;
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c == bc) {
            at[c] -= 1;
            h[c] = at[c] >= 0 ? g[(at[c] * C + c) * share] : kEmpty;
          }
        }
      }
      float nbv[KC], exv[KC];
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        const int j = m[e] == kEmpty ? 0 : ws::key_index(m[e]);
        nbv[e] = a.nb[j];
        exv[e] = a.ext[j];
      }
      Walk w;
#pragma unroll
      for (int e = 0; e < KC; ++e) {
        if (e < nk && !w.done && !w.ended) {
          if (m[e] == kEmpty) w.ended = true;  // no valid row left
          else w.take(ws::key_dist(m[e]), nbv[e], exv[e], mp);
        }
      }
      v = w.value(mp, a.dim);
    }
    if (p < Lp) a.out[p - a.block0 * kRows] = v;
  }
  count_visits(a.visits, visited, min(kRows, Lp - x0));
}

// ------------------------------------- k > kRegK: the warp-select route
// Shared-memory plan (bytes): the block's rows (or a feature slice of them)
// and a tile, at grid_ws.cuh's row stride; each row's owner's broadcast
// (goes on, last key taken); with a cluster, a pass's selected keys (K a
// row).
struct WsPlan : gw::Slices {
  size_t xs, ys, bneed, blo, lst, bytes;
  __host__ __device__ WsPlan(int d_, int K, int R, int C) : gw::Slices(d_) {
    xs = 0;
    ys = sizeof(float) * kRows * sd;
    size_t at = ys + sizeof(float) * kMaxTile * sd;
    bneed = at;
    at += sizeof(int) * kRows;
    blo = at = (at + 7) & ~size_t(7);
    at += sizeof(Key) * kRows;
    lst = at;
    at += C > 1 ? sizeof(Key) * gw::kWarps * R * K : 0;
    bytes = (at + 15) & ~size_t(15);
  }
};

// nblocks * G pass groups, a cluster of C CTAs each (a group's W).
template <int K>
__global__ void __launch_bounds__(gw::kThreads)
grid_cd_ws_kernel(const Args a, int C) {
  using S = gw::CdShape<K>;
  constexpr int R = S::R, TQ = S::T, Q = K / 32, W = gw::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const WsPlan P(a.d, K, R, C);
  const int G = a.cta < S::kPasses ? a.cta : S::kPasses;  // pass groups of the block
  float* xs = reinterpret_cast<float*>(smem + P.xs);
  float* ys = reinterpret_cast<float*>(smem + P.ys);
  int* bneed = reinterpret_cast<int*>(smem + P.bneed);
  Key* blo = reinterpret_cast<Key*>(smem + P.blo);
  Key* lst = reinterpret_cast<Key*>(smem + P.lst);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const int group = static_cast<int>(blockIdx.x) / C;
  const int blk = a.block0 + group / G;
  const int x0 = blk * kRows, Lp = a.Lp, T = a.T, NT = a.NT;
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.pts) % 16 == 0;
  const int* ord = a.order + (size_t)blk * NT;
  const float* lb = a.lbs + (size_t)blk * NT;
  const float mp = static_cast<float>(a.min_pts);
  if (P.n == 1) gw::stage(xs, a.pts, x0, kRows, Lp, a.d, 0, P.dp, P.sd, vec4);  // visible after visit's barrier
  cg::cluster_group cluster = cg::this_cluster();
  unsigned long long visited = 0;
  int walked = 0;  // tiles this CTA visited, over its passes and rounds
  Key* rows_l = lst + (size_t)warp * R * K;  // this warp's rows' selected keys, K a row

  for (int pass = group % G; pass < S::kPasses; pass += G) {
    const int row_off = pass * W * R + warp * R;
    const int owner = warp % C;  // the CTA whose warp merges and walks these rows
    const bool mine = owner == rank;
    float xx[R];
    int o_r[R];
    bool rv[R], need[R];
    Key lo[R];
    Walk st[R];
    gw::warp_norms<R>(a.pts, x0 + row_off, Lp, a.d, xx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = x0 + row_off + r;
      rv[r] = p < Lp && a.valid[p];
      o_r[r] = p < Lp ? a.orig[p] : -1;
      lo[r] = 0;
      need[r] = rv[r];
    }
    const int rows_here = max(0, min(W * R, Lp - (x0 + pass * W * R)));  // of the block, this pass
    for (int kdone = 0; kdone < a.k; kdone += K) {
      const int kq = min(K, a.k - kdone);
      bool any_need = false;
#pragma unroll
      for (int r = 0; r < R; ++r) any_need |= need[r];
      if (!__syncthreads_or(any_need)) break;  // the same in every CTA of the cluster
      ws::WarpSelect<K, TQ> sel[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sel[r].init();
      bool go = rank < NT && lb[rank] < inf();
      for (int t = rank; go; t += C) {
        const int tile = ord[t];
        float acc[R], yy;
        gw::visit<R>(xs, ys, a.pts, x0, Lp, a.pts, tile, T, Lp, P, vec4, vec4, row_off, acc, yy);
        const int p = tile * T + lane;
        const bool cv = lane < T && a.valid[p];
        const int o_c = cv ? a.orig[p] : 0;
        float sq[R];
        bool pass_any = false;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float tt = __fsub_rn(__fadd_rn(xx[r], yy), __fmul_rn(2.f, acc[r]));
          if (o_c == o_r[r]) tt = 0.f;  // the row itself, exactly 0
          sq[r] = fmaxf(tt, 0.f);
          pass_any |= need[r] && cv && !(sq[r] >= sel[r].thr2);
        }
        if (__any_sync(kFull, pass_any)) {
          bool full = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            gw::offer_from(sel[r], sq[r], o_c, need[r] && cv, lo[r]);
            full |= sel[r].nv == TQ;
          }
          if (__any_sync(kFull, full)) {
#pragma unroll
            for (int r = 0; r < R; ++r) sel[r].merge_if(sel[r].nv == TQ, lane, kq);
          }
        }
        visited += rows_here;
        ++walked;
        bool want = false;
        const float nl = t + C < NT ? lb[t + C] : inf();
        if (nl < inf()) {
#pragma unroll
          for (int r = 0; r < R; ++r) want |= need[r] && nl <= kth_dist(sel[r].kth);
        }
        go = __syncthreads_or(want);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) sel[r].merge_if(sel[r].nv > 0, lane, kq);
      if (C > 1) {
        // Every CTA's first kq keys of each row (kEmpty past them); the owner
        // folds each peer's sorted list into its queue: the minimum against
        // the list reversed, then bitonic half-cleaners.
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int e = q * 32 + lane;
            rows_l[r * K + e] = e < kq ? sel[r].w[q] : kEmpty;
          }
        }
        cluster.sync();  // every CTA's lists written
        if (mine) {
          for (int c = 0; c < C; ++c) {
            if (c == rank) continue;
            const Key* peer = cluster.map_shared_rank(rows_l, c);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              if (need[r]) {
#pragma unroll
                for (int q = 0; q < Q; ++q) sel[r].w[q] = ws::kmin(sel[r].w[q], peer[r * K + K - 1 - (q * 32 + lane)]);
                ws::bitonic_stages<Q, K, K / 2>(sel[r].w, lane);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) sel[r].kth = __shfl_sync(kFull, ws::pick(sel[r].w, (kq - 1) >> 5), (kq - 1) & 31);
        }
      }
      if (mine) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (need[r]) {
            gw::walk(sel[r], kq, a.nb, a.ext, mp, st[r]);
            if (!st[r].done) {
              if (sel[r].kth == kEmpty) st[r].ended = true;
              else lo[r] = sel[r].kth + 1;  // the next round takes the keys above this one's last
            }
            need[r] = !st[r].done && !st[r].ended;
          }
        }
      }
      if (C > 1) {
        // The owner's (goes on, last key) to the cluster.
        if (lane == 0 && mine) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            bneed[row_off + r] = need[r];
            blo[row_off + r] = lo[r];
          }
        }
        cluster.sync();  // the broadcast written, every peer's lists read
        if (!mine) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            need[r] = *cluster.map_shared_rank(bneed + row_off + r, owner) != 0;
            lo[r] = *cluster.map_shared_rank(blo + row_off + r, owner);
          }
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int p = x0 + row_off + r;
        if (lane == 0 && p < Lp) a.out[p - a.block0 * kRows] = rv[r] ? st[r].value(mp, a.dim) : 0.f;
      }
    }
  }
  if (C > 1) cluster.sync();  // no CTA leaves while a peer reads its shared memory
  if (a.visits != nullptr && tid == 0) {
    atomicAdd(a.visits, visited);
    atomicMax(a.visits + 1, (unsigned long long)walked);
  }
}

// The register route's launch, lists of KC slots.
template <int KC>
int launch_reg(const Args& args, int nblocks, int C, void* stream) {
  const int DP = width_for(args.d);
  const RegPlan<KC> P(args.d, DP);
  void (*kernel)(const Args, int) = DP == 16    ? grid_cd_reg_kernel<16, KC>
                                    : DP == 32  ? grid_cd_reg_kernel<32, KC>
                                    : DP == 64  ? grid_cd_reg_kernel<64, KC>
                                    : DP == 128 ? grid_cd_reg_kernel<128, KC>
                                                : grid_cd_reg_kernel<0, KC>;
  return launch_clusters(kernel, args, nblocks, C, P.bytes, stream);
}

// At most C CTAs a block: G = min(C, kPasses) pass groups of W = min(C / G,
// kWsSplit) CTAs, a cluster each.
template <int K>
int launch_ws(const Args& args, int nblocks, int C, void* stream) {
  using S = gw::CdShape<K>;
  const int G = C < S::kPasses ? C : S::kPasses;
  const int W = C / G < kWsSplit ? C / G : kWsSplit;
  const WsPlan P(args.d, K, S::R, W);
  return launch_clusters(grid_cd_ws_kernel<K>, args, nblocks * G, W, P.bytes, stream, gw::kThreads);
}

}  // namespace

// The sorted table (pts (Lp, d) f32, orig (Lp,) int32, valid (Lp,) bool in
// NT tiles of T rows), its own rows as queries in ceil(Lp / 64) blocks with
// their visit lists order (ceil(Lp / 64), NT) int32 and lbs f32 (ascending
// lb - slack in distance space), of which this launch runs [block0, block0 +
// nblocks); nb, ext (Lp,) f32 in original order; 1 <= k = min(min_pts, Lp);
// cluster C in {1, 2, 4, 8}: CTAs a query block; out (nblocks * 64,) f32:
// the blocks' rows in sorted order (0 on invalid rows); visits: null or two
// 64-bit counters (rows x tiles visited, added; the longest walk of a CTA, a
// maximum).  Returns cudaGetLastError() after the launch.
extern "C" int repro_grid_cd_tiles_f32(const void* pts, const void* orig, const void* valid, int Lp, int d, int T,
                                       const void* order, const void* lbs, int NT, const void* nb, const void* ext,
                                       int k, int min_pts, int dim, int block0, int nblocks, int cluster, void* out,
                                       void* visits, void* stream) {
  if (bad_grid(Lp, d, T, NT) || bad_blocks(Lp, block0, nblocks) || k < 1 || k > Lp || min_pts < 1 || dim < 1 ||
      !good_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{static_cast<const float*>(pts), static_cast<const int*>(orig), static_cast<const bool*>(valid),
                  Lp, d, T, static_cast<const int*>(order), static_cast<const float*>(lbs), NT,
                  static_cast<const float*>(nb), static_cast<const float*>(ext), k, min_pts, dim, block0, cluster,
                  static_cast<float*>(out), static_cast<unsigned long long*>(visits)};
  if (k <= kRegK) return k <= kRegSmall ? launch_reg<kRegSmall>(args, nblocks, cluster, stream)
                                         : launch_reg<kRegK>(args, nblocks, cluster, stream);
  switch (ws::queue_for(min(k, ws::kMaxK))) {
    case 32: return launch_ws<32>(args, nblocks, cluster, stream);
    case 64: return launch_ws<64>(args, nblocks, cluster, stream);
    case 128: return launch_ws<128>(args, nblocks, cluster, stream);
    case 256: return launch_ws<256>(args, nblocks, cluster, stream);
    case 512: return launch_ws<512>(args, nblocks, cluster, stream);
    default: return launch_ws<1024>(args, nblocks, cluster, stream);
  }
}
