// The 64 x 64 distance tile shared by the pairwise and mutual_reach kernels.
//
// A block of 32 x 8 threads stages a 64-row tile of x and of y in shared
// memory, computes the 128 row norms with dot_chain, and each thread
// accumulates the dot products of 8 x rows by 2 y columns with one FMA per
// feature in ascending order.  Both kernels run this one code, so the same
// pair gives the same squared-distance bits in both.  Thread (tx, ty) owns
// rows ty + 8i and columns tx + 32j of the tile: a warp's store covers 32
// consecutive floats of one output row (128 contiguous bytes).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTile = 64;
constexpr int kTileTx = 32, kTileTy = 8;
constexpr int kTileRows = kTile / kTileTy;  // 8 output rows per thread
constexpr int kTileCols = kTile / kTileTx;  // 2 output columns per thread

struct DistTile {
  float acc[kTileRows][kTileCols];  // x_r . y_c
  const float* xn;                  // kTile norms of the x rows, in shared memory
  const float* yn;                  // kTile norms of the y rows

  __device__ __forceinline__ float sq(int i, int j) const {
    return expanded_sq(xn[threadIdx.y + i * kTileTy], yn[threadIdx.x + j * kTileTx], acc[i][j]);
  }
};

__host__ __device__ inline size_t dist_tile_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kTile * smem_stride(d) + 2 * kTile);
}

// Tile (blockIdx.y, blockIdx.x) of x (n, d) against y (m, d); rows past n
// or m are zero.  `smem` holds dist_tile_smem_bytes(d).
__device__ __forceinline__ DistTile dist_tile(const float* __restrict__ x,
                                              const float* __restrict__ y, int n, int m, int d,
                                              float* smem) {
  const int ds = smem_stride(d);
  float* xs = smem;
  float* ys = xs + kTile * ds;
  float* xn = ys + kTile * ds;
  float* yn = xn + kTile;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileTx + tx;

  stage_rows(xs, x, r0, kTile, n, d);
  stage_rows(ys, y, c0, kTile, m, d);
  __syncthreads();
  if (tid < kTile) {
    xn[tid] = dot_chain(xs + tid * ds, xs + tid * ds, d);
  } else if (tid < 2 * kTile) {
    const int j = tid - kTile;
    yn[j] = dot_chain(ys + j * ds, ys + j * ds, d);
  }
  __syncthreads();

  DistTile t;
  t.xn = xn;
  t.yn = yn;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) t.acc[i][j] = 0.f;
  for (int k = 0; k < d; ++k) {
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
  return t;
}

}  // namespace repro
