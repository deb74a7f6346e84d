// Eq. 7 mutual-reachability tiles (the port of the JAX package's Pallas
// kernel repro/kernels/mutual_reach.py::_mutual_reach_kernel).
//
//   out[r, c] = max(sqrt(max(|x_r|^2 + |y_c|^2 - 2 x_r.y_c, 0)), cd_x[r], cd_y[c])
//
// with the global diagonal at 0 when zero_diag, and -- fused here instead
// of a second pass over the matrix -- +inf on every row and column at or
// past n_valid (the offline pass's pad bubbles, which Borůvka must never
// connect; the JAX package applies that mask with a separate where).
//
// 64 x 64 output tile per block of 32 x 8 threads: both row tiles sit in
// shared memory, each thread accumulates 8 x 2 outputs with an FMA loop over
// d, and a warp writes 32 consecutive floats of one row per store.
#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kTx = 32, kTy = 8;
constexpr int kRows = kTile / kTy;  // 8 output rows per thread
constexpr int kCols = kTile / kTx;  // 2 output columns per thread

__global__ void __launch_bounds__(kTx * kTy)
mutual_reach_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ cdx, const float* __restrict__ cdy, int n, int m,
                    int d, int zero_diag, int n_valid, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int ds = repro::smem_stride(d);
  float* xs = smem;
  float* ys = xs + kTile * ds;
  float* xn = ys + kTile * ds;
  float* yn = xn + kTile;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;

  repro::stage_rows(xs, x, r0, kTile, n, d);
  repro::stage_rows(ys, y, c0, kTile, m, d);
  __syncthreads();
  if (tid < kTile) {
    xn[tid] = repro::dot_chain(xs + tid * ds, xs + tid * ds, d);
  } else if (tid < 2 * kTile) {
    const int j = tid - kTile;
    yn[j] = repro::dot_chain(ys + j * ds, ys + j * ds, d);
  }
  __syncthreads();

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d; ++k) {
    float yv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) yv[j] = ys[(tx + j * kTx) * ds + k];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float xv = xs[(ty + i * kTy) * ds + k];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = __fmaf_rn(xv, yv[j], acc[i][j]);
    }
  }

  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int lr = ty + i * kTy, r = r0 + lr;
    if (r >= n) continue;
    const float cr = cdx[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int lc = tx + j * kTx, c = c0 + lc;
      if (c >= m) continue;
      const float dist = sqrtf(repro::expanded_sq(xn[lr], yn[lc], acc[i][j]));
      float v = fmaxf(dist, fmaxf(cr, cdy[c]));
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
extern "C" int repro_mutual_reach_f32(const void* x, const void* y, const void* cdx,
                                      const void* cdy, int n, int m, int d, int zero_diag,
                                      int n_valid, void* out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || d > repro::kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const int ds = repro::smem_stride(d);
  const size_t smem = sizeof(float) * (2 * (size_t)kTile * ds + 2 * kTile);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kTx, kTy);
  if (smem > 48 * 1024) {  // wide d: opt in to more than the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        mutual_reach_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mutual_reach_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const float*>(cdx),
      static_cast<const float*>(cdy), n, m, d, zero_diag, n_valid, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
