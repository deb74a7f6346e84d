// The tile walk shared by the grid's redesigned kernels, grid_round.cu,
// grid_assign.cu and grid_cd.cu (plain C interface, sm_90a).  A block of 64
// query rows, a thread a row, walks its list of the table's tiles in
// ascending lower bound, split across a thread-block cluster of C CTAs: rank
// r visits positions r, r + C, r + 2C, ... of the block's order.  A ring of stages
// in shared memory, filled by cp.async copies visits ahead, holds each
// visit's tile rows (and past one slice of kSlice features, a slice of them
// and of the block's query rows); one warp writes each iteration's (tile,
// bound) into a small header ring a visit before its copies start.  At the
// end the C partial answers per row merge through distributed shared memory
// in an order that does not depend on C.
//
// Here: the sizes and the launch's checks, the square cap of a distance
// bound, the ring's slice geometry, the copies, the visit list and its
// header ring, a peer's published value, the cluster's (value, index) merge
// and the cluster launch.  Each kernel keeps its ring depth kStages, its
// regions past the ring, its FMA chains and its candidates.
#pragma once

#include <cuda_runtime.h>

#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro::tiles {

namespace cg = cooperative_groups;

constexpr int kRows = 64;  // query rows a block: kernels/grid.py DEFAULT_BLOCK
constexpr int kWarps = kRows / 32;
constexpr int kThreads = kRows;  // a row a thread
constexpr int kMaxTile = 32;     // tile rows: the columns a row sweeps
constexpr int kSlice = 128;      // features a stage
constexpr int kMaxCluster = 8;   // CTAs a block at most: kernels/grid.py CLUSTERS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_() { return __int_as_float(0x7fffffff); }

// The compiled feature width of a launch: d up to 128 runs one slice of DP
// = 16, 32, 64 or 128 features (zero past d, which leaves every chain's
// bits alone) with the loops unrolled; wider d runs DP = 0, slices of
// kSlice features.
inline int width_for(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0; }

inline bool good_cluster(int C) { return C == 1 || C == 2 || C == 4 || C == kMaxCluster; }

inline bool bad_grid(int Lp, int d, int T, int NT) {
  return Lp <= 0 || d <= 0 || T <= 0 || T > kMaxTile || NT <= 0 || (long long)T * NT != Lp ||
         (long long)Lp * Lp >= INT_MAX;
}

// [block0, block0 + nblocks) within the table's ceil(Lp / 64) query blocks
inline bool bad_blocks(int Lp, int block0, int nblocks) {
  return block0 < 0 || nblocks < 1 || block0 > (Lp + kRows - 1) / kRows - nblocks;
}

// A squared distance above sq_cap(c) has a root above c: the product
// (c+)^2 of c's successor rounded up; +inf for c = +inf.
__device__ __forceinline__ float sq_cap(float c) {
  const float up = __int_as_float(__float_as_int(c) + 1);
  return c < inf() ? __fmul_ru(up, up) : inf();
}

// The ring's geometry: the padded width dp, the slice width w, its row
// stride sd = w | 4 floats (an odd count of 16-byte groups: the 16-byte
// loads of 8 consecutive rows hit distinct banks) and the slices sn; the
// byte offsets of the block's query rows (xs, held whole where sn == 1) and
// of the ring of nstages stages of stage_floats floats, and the ring's end,
// where a kernel's own regions start.
struct Slices {
  int d, dp, w, sd, sn;  // features, padded width, slice width, row stride, slices
  size_t xs, stages, stage_floats, end;
  __host__ __device__ Slices(int d_, int DP, int nstages) : d(d_) {
    dp = DP > 0 ? DP : (d + 3) & ~3;
    w = dp < kSlice ? dp : kSlice;
    sd = w | 4;
    sn = (dp + w - 1) / w;
    stage_floats = (size_t)kMaxTile * sd + (sn > 1 ? (size_t)kRows * sd : 0);
    xs = 0;
    stages = sn == 1 ? sizeof(float) * kRows * sd : 0;
    end = (stages + sizeof(float) * nstages * stage_floats + 15) & ~size_t(15);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4b(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of features [k0, k0 + width) of rows [r0, r0 + rows) of
// the row-major (n, d) table into dst (row stride sd), zero past n and d:
// 16 bytes a copy when vec4 (d % 4 == 0, 16-byte aligned), else 4.
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int r0, int rows, int n, int d,
                                          int k0, int width, int sd, bool vec4) {
  if (vec4) {
    const int groups = width / 4;
    for (int t = threadIdx.x; t < rows * groups; t += kThreads) {
      const int r = t / groups, f = k0 + 4 * (t - r * groups);
      const bool ok = r0 + r < n && f < d;
      repro::cp_async16(dst + r * sd + (f - k0), ok ? src + (size_t)(r0 + r) * d + f : src, ok);
    }
  } else {
    for (int t = threadIdx.x; t < rows * width; t += kThreads) {
      const int r = t / width, f = k0 + (t - r * width);
      const bool ok = r0 + r < n && f < d;
      repro::cp_async4(dst + r * sd + (f - k0), ok ? src + (size_t)(r0 + r) * d + f : src, ok);
    }
  }
}

// A visit's raw (tile, lb, in range), loaded clamped and resolved a visit
// later.
struct Raw {
  int tile;
  float l;
  bool ok;
};

// The header ring as its warp keeps it: kHdr entries of (tile, bound) in
// shared memory (t, l), one an iteration, where iteration q is visit
// q / sn, feature slice q % sn, and the CTA's visit v is position
// rank + v·C of its block's order (ord, lb).  (cur_t, cur_l) is the visit
// in progress at the iteration written last, (-1, +inf) past the order's
// end; nxt the raw visit of the iteration after, where that starts one.
template <int kHdr>
struct Headers {
  int* t;
  float* l;
  const int* ord;
  const float* lb;
  int NT, rank, C, sn, lane;
  int cur_t;
  float cur_l;
  Raw nxt;

  __device__ __forceinline__ Headers(int* t_, float* l_, const int* ord_, const float* lb_, int NT_, int rank_, int C_,
                                     int sn_, int lane_)
      : t(t_), l(l_), ord(ord_), lb(lb_), NT(NT_), rank(rank_), C(C_), sn(sn_), lane(lane_), cur_t(-1), cur_l(inf()),
        nxt{0, 0.f, false} {}
  __device__ __forceinline__ Raw load(int v) const {
    const int at = rank + v * C;
    const int tc = min(at, NT - 1);
    return Raw{ord[tc], lb[tc], at < NT};
  }
  __device__ __forceinline__ void resolve(const Raw& r) {
    cur_l = r.ok ? r.l : inf();
    cur_t = r.ok && r.l < inf() ? r.tile : -1;
  }
  __device__ __forceinline__ void write(int q) {
    if (lane == 0) {
      t[q % kHdr] = cur_t;
      l[q % kHdr] = cur_l;
    }
  }
  // The prologue's iteration q: its visit loaded and resolved at once.
  __device__ __forceinline__ void prime(int q) {
    if (q % sn == 0) resolve(load(q / sn));
    write(q);
  }
  // The raw visit of iteration q, where q starts one.
  __device__ __forceinline__ void fetch(int q) {
    if (q % sn == 0) nxt = load(q / sn);
  }
  // The walk's iteration q: the visit fetched an iteration before resolved.
  __device__ __forceinline__ void step(int q) {
    if (q % sn == 0) resolve(nxt);
    write(q);
  }
};

// A row's (value, index).
struct Best {
  float v;
  int e;
};

// The value at `mine` as peer CTA `rank` of the cluster last published it in
// its shared memory: a 32-bit distributed-shared-memory address mapped and
// read where it is used (volatile: never hoisted into a register held across
// the walk).
__device__ __forceinline__ float peer_best(const float* mine, int rank) {
  uint32_t at;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(at) : "r"(smem_u32(mine)), "r"(rank));
  asm volatile("ld.volatile.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(at));
  return v;
}

// Row i of the block: the lexicographic minimum of the C CTAs' (vs[i],
// es[i]), read through distributed shared memory.
__device__ __forceinline__ Best cluster_min(cg::cluster_group& cluster, const float* vs, const int* es, int i, int C) {
  Best b{inf(), INT_MAX};
  for (int c = 0; c < C; ++c) {
    const float ov = *cluster.map_shared_rank(vs + i, c);
    const int oe = *cluster.map_shared_rank(es + i, c);
    if (ov < b.v || (ov == b.v && oe < b.e)) b = Best{ov, oe};
  }
  return b;
}

// The walk's counters, by thread 0: rows x tiles visited, added, and the
// longest walk of a CTA, a maximum.
__device__ __forceinline__ void count_visits(unsigned long long* visits, int visited, int rows) {
  if (visits != nullptr && threadIdx.x == 0) {
    atomicAdd(visits, (unsigned long long)visited * rows);
    atomicMax(visits + 1, (unsigned long long)visited);
  }
}

// kernel(args, C) over nblocks query blocks of C CTAs of `threads`, a
// thread-block cluster a block, with bytes of dynamic shared memory.
// Returns cudaGetLastError() after the launch.
template <typename Args>
inline int launch_clusters(void (*kernel)(const Args, int), const Args& args, int nblocks, int C, size_t bytes,
                           void* stream, int threads = kThreads) {
  const cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nblocks * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, kernel, args, C);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro::tiles
