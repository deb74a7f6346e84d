// Nearest-representative assignment (the port of the JAX package's Pallas
// kernel repro/kernels/assign.py::_assign_kernel).
//
// For each query row: the lowest index j attaining min_j max(|x|^2 + |r_j|^2
// - 2 x.r_j, 0), and optionally sqrt of that minimum.  One warp per query
// row group: a block holds kWarps warps x kRowsPerWarp rows, streams the rep
// table through shared memory in chunks, and every lane keeps a running
// (min, idx) per row over the columns it visits in ascending order with a
// strict '<' -- so the lowest index wins inside a lane, and the warp-wide
// lexicographic (value, index) reduction keeps it across lanes and chunk
// borders.  The ragged edges are masked; nothing is padded.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;  // rows sharing each staged rep read
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunkFloats = 4096;  // rep chunk budget in shared memory

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ reps, int n, int L,
              int d, int chunk, int* __restrict__ idx_out, float* __restrict__ dist_out) {
  extern __shared__ float smem[];
  const int ds = repro::smem_stride(d);
  float* rs = smem;                  // chunk x ds staged reps
  float* rr = rs + chunk * ds;       // chunk rep norms
  float* xs = rr + chunk;            // kRowsPerBlock x ds query rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock;

  repro::stage_rows(xs, x, row0, kRowsPerBlock, n, d);
  __syncthreads();
  const float* xw = xs + warp * kRowsPerWarp * ds;
  float xx[kRowsPerWarp], best[kRowsPerWarp];
  int bidx[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    xx[r] = repro::dot_chain(xw + r * ds, xw + r * ds, d);
    best[r] = __int_as_float(0x7f800000);  // +inf
    bidx[r] = INT_MAX;
  }

  for (int c0 = 0; c0 < L; c0 += chunk) {
    const int cn = min(chunk, L - c0);
    __syncthreads();  // previous chunk fully consumed
    repro::stage_rows(rs, reps, c0, cn, L, d);
    __syncthreads();
    for (int j = threadIdx.x; j < cn; j += kThreads) rr[j] = repro::dot_chain(rs + j * ds, rs + j * ds, d);
    __syncthreads();
    for (int j = lane; j < cn; j += 32) {
      const float* p = rs + j * ds;
      float dot[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.f;
      for (int k = 0; k < d; ++k) {
        const float pk = p[k];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = __fmaf_rn(xw[r * ds + k], pk, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float sq = repro::expanded_sq(xx[r], rr[j], dot[r]);
        // the first candidate always lands, so a row never keeps INT_MAX
        if (sq < best[r] || bidx[r] == INT_MAX) {
          best[r] = sq;
          bidx[r] = c0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    repro::warp_argmin(best[r], bidx[r]);
    const int row = row0 + warp * kRowsPerWarp + r;
    if (lane == 0 && row < n) {
      idx_out[row] = bidx[r];
      if (dist_out != nullptr) dist_out[row] = sqrtf(best[r]);
    }
  }
}

}  // namespace

// x (n, d), reps (L, d) row-major f32 on the device; idx_out (n,) int32;
// dist_out (n,) f32 or null.  Returns cudaGetLastError() after the launch.
extern "C" int repro_assign_f32(const void* x, const void* reps, int n, int L, int d,
                                void* idx_out, void* dist_out, void* stream) {
  if (n <= 0 || L <= 0 || d <= 0 || d > repro::kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  const int ds = repro::smem_stride(d);
  int chunk = (kChunkFloats / (ds + 1)) & ~31;
  if (chunk < 32) chunk = 32;
  const size_t smem = sizeof(float) * ((size_t)chunk * (ds + 1) + (size_t)kRowsPerBlock * ds);
  const int grid = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  assign_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(reps), n, L, d, chunk,
      static_cast<int*>(idx_out), static_cast<float*>(dist_out));
  return static_cast<int>(cudaGetLastError());
}
