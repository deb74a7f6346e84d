// The 64 x 64 distance tile shared by the pairwise and mutual_reach kernels.
//
// A block of 32 x 8 threads walks the feature axis in slices of at most
// kSlice features: per slice it stages a 64 x slice piece of x and of y in
// shared memory, threads 0..127 continue the 128 row norms, and each
// thread continues the dot products of 8 x rows by 2 y columns with one FMA
// per feature.  The products stay in registers and the norms in shared
// memory across slices, so every dot product and norm is one __fmaf_rn
// chain over the features in ascending order -- bitwise what one unsliced
// chain gives -- at any d, while shared memory stays at
// dist_tile_smem_bytes(d) <= 34 KB.  Both
// kernels run this one code, so the same pair gives the same
// squared-distance bits in both.  Thread (tx, ty) owns rows ty + 8i and
// columns tx + 32j of the tile: a warp's store covers 32 consecutive
// floats of one output row (128 contiguous bytes).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTile = 64;
constexpr int kTileTx = 32, kTileTy = 8;
constexpr int kTileRows = kTile / kTileTy;  // 8 output rows per thread
constexpr int kTileCols = kTile / kTileTx;  // 2 output columns per thread
constexpr int kSlice = 64;                  // features staged per step

struct DistTile {
  float acc[kTileRows][kTileCols];  // x_r . y_c
  const float* xn;                  // kTile norms of the x rows, in shared memory
  const float* yn;                  // kTile norms of the y rows

  __device__ __forceinline__ float sq(int i, int j) const {
    return expanded_sq(xn[threadIdx.y + i * kTileTy], yn[threadIdx.x + j * kTileTx], acc[i][j]);
  }
};

__host__ __device__ inline int dist_tile_width(int d) { return d < kSlice ? d : kSlice; }

__host__ __device__ inline size_t dist_tile_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kTile * smem_stride(dist_tile_width(d)) + 2 * kTile);
}

// Tile (blockIdx.y, blockIdx.x) of x (n, d) against y (m, d); rows past n
// or m are zero.  `smem` holds dist_tile_smem_bytes(d).  kOneSlice: the
// kernel was launched for d <= kSlice, so the slice loop runs once, known
// at compile time (the loop in its runtime form slowed both kernels at
// d = 16 on the H100; PERF.md).
template <bool kOneSlice>
__device__ __forceinline__ DistTile dist_tile(const float* __restrict__ x,
                                              const float* __restrict__ y, int n, int m, int d,
                                              float* smem) {
  const int ds = smem_stride(dist_tile_width(d));
  float* xs = smem;
  float* ys = xs + kTile * ds;
  float* xn = ys + kTile * ds;
  float* yn = xn + kTile;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileTx + tx;

  DistTile t;
  t.xn = xn;
  t.yn = yn;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) t.acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kSlice) {
    const int w = kOneSlice ? d : min(kSlice, d - k0);
    if (!kOneSlice && k0) __syncthreads();  // the previous slice is consumed
    stage_rows(xs, x, r0, kTile, n, d, k0, w, ds);
    stage_rows(ys, y, c0, kTile, m, d, k0, w, ds);
    __syncthreads();
    // threads 0..127 continue the norms of x row tid and y row tid - 64
    if (tid < kTile) {
      xn[tid] = dot_chain(xs + tid * ds, xs + tid * ds, w, !kOneSlice && k0 ? xn[tid] : 0.f);
    } else if (tid < 2 * kTile) {
      const int j = tid - kTile;
      yn[j] = dot_chain(ys + j * ds, ys + j * ds, w, !kOneSlice && k0 ? yn[j] : 0.f);
    }
    // the norms are complete before the last slice's products, so each warp
    // goes on to its stores as soon as its own products are done
    __syncthreads();
    for (int k = 0; k < w; ++k) {
      float yv[kTileCols];
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) yv[j] = ys[(tx + j * kTileTx) * ds + k];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        const float xv = xs[(ty + i * kTileTy) * ds + k];
#pragma unroll
        for (int j = 0; j < kTileCols; ++j) t.acc[i][j] = __fmaf_rn(xv, yv[j], t.acc[i][j]);
      }
    }
    if (kOneSlice) break;
  }
  return t;
}

}  // namespace repro
