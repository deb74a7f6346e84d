// Tiled squared euclidean distances: the first port of the JAX package's
// Pallas kernel repro/kernels/pairwise.py::_pairwise_kernel, kept as the
// bitwise oracle of dist_panel.cu and reached only through
// pairwise.pairwise_tile.
//
//   out[r, c] = max(|x_r|^2 + |y_c|^2 - 2 x_r.y_c, 0)
//
// Bound by its output bytes: n * m * 4 written once, against n * m * d
// FMAs on small d.  64 x 64 output tile per block of 32 x 8 threads
// (dist_tile.cuh, shared with the mutual_reach kernel, so the two give the
// same squared-distance bits for the same pair); a warp writes 32
// consecutive floats of one output row per store.
#include "dist_tile.cuh"

namespace {

using repro::kTile;
using repro::kTileCols;
using repro::kTileRows;
using repro::kTileTx;
using repro::kTileTy;

template <bool kOneSlice>
__global__ void __launch_bounds__(kTileTx * kTileTy)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int d,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  const repro::DistTile t = repro::dist_tile<kOneSlice>(x, y, n, m, d, smem);
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const int r = r0 + threadIdx.y + i * kTileTy;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) {
      const int c = c0 + threadIdx.x + j * kTileTx;
      if (c < m) out[(size_t)r * m + c] = t.sq(i, j);
    }
  }
}

}  // namespace

// x (n, d), y (m, d) row-major f32 on the device; out (n, m) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_pairwise_tile_f32(const void* x, const void* y, int n, int m, int d, void* out,
                                       void* stream) {
  if (n <= 0 || m <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = repro::dist_tile_smem_bytes(d);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kTileTx, kTileTy);
  const auto kernel = d <= repro::kSlice ? pairwise_kernel<true> : pairwise_kernel<false>;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
