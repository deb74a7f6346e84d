// Eq. 7 mutual-reachability tiles: the first port of the JAX package's
// Pallas kernel repro/kernels/mutual_reach.py::_mutual_reach_kernel, kept
// as the bitwise oracle of dist_panel.cu and reached only through
// mutual_reach.mutual_reach_tile.
//
//   out[r, c] = max(sqrt(max(|x_r|^2 + |y_c|^2 - 2 x_r.y_c, 0)), cd_x[r], cd_y[c])
//
// with the global diagonal at 0 when zero_diag, and -- fused here instead
// of a second pass over the matrix -- +inf on every row and column at or
// past n_valid (the offline pass's pad bubbles, which Borůvka must never
// connect; the JAX package applies that mask with a separate where).
//
// 64 x 64 output tile per block of 32 x 8 threads (dist_tile.cuh, shared
// with the pairwise kernel, so both give the same squared-distance bits):
// both row tiles sit in shared memory, each thread accumulates 8 x 2
// outputs with an FMA loop over d, and a warp writes 32 consecutive floats
// of one row per store.
#include "dist_tile.cuh"

namespace {

using repro::kTile;
using repro::kTileCols;
using repro::kTileRows;
using repro::kTileTx;
using repro::kTileTy;

template <bool kOneSlice>
__global__ void __launch_bounds__(kTileTx * kTileTy)
mutual_reach_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ cdx, const float* __restrict__ cdy, int n, int m,
                    int d, int zero_diag, int n_valid, float* __restrict__ out) {
  extern __shared__ float smem[];
  const repro::DistTile t = repro::dist_tile<kOneSlice>(x, y, n, m, d, smem);
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const int r = r0 + threadIdx.y + i * kTileTy;
    if (r >= n) continue;
    const float cr = cdx[r];
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) {
      const int c = c0 + threadIdx.x + j * kTileTx;
      if (c >= m) continue;
      float v = fmaxf(sqrtf(t.sq(i, j)), fmaxf(cr, cdy[c]));
      if (zero_diag && r == c) v = 0.f;
      if (r >= n_valid || c >= n_valid) v = inf;
      out[(size_t)r * m + c] = v;
    }
  }
}

}  // namespace

// x (n, d), y (m, d), cdx (n,), cdy (m,) f32 on the device; out (n, m) f32.
// Rows and columns >= n_valid come out +inf (pass n_valid >= max(n, m) for
// no mask).  Returns cudaGetLastError() after the launch.
extern "C" int repro_mutual_reach_tile_f32(const void* x, const void* y, const void* cdx,
                                           const void* cdy, int n, int m, int d, int zero_diag,
                                           int n_valid, void* out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::dist_tile_smem_bytes(d);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kTileTx, kTileTy);
  const auto kernel = d <= repro::kSlice ? mutual_reach_kernel<true> : mutual_reach_kernel<false>;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(cdx),
      static_cast<const float*>(cdy), n, m, d, zero_diag, n_valid, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
