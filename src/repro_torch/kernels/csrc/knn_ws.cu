// k nearest neighbours (the port of the JAX package's Pallas kernel
// repro/kernels/knn.py::_knn_kernel), on the warp-select core.
//
// For query row i: the k smallest sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0))
// over the rows j of y, ascending, with their indices; equal distances keep
// the lower index first (the order of a stable sort and of jax.lax.top_k).
//
// Bound on the H100: operations, n·m·d FMAs.  warp_select.cuh keeps R query
// rows per warp in registers and streams y through a cp.async ring once per
// block of 8·R rows, so each y element read from shared memory feeds R FMAs;
// the k nearest per row stay in registers (per-lane thread queues and a warp
// queue of K >= k keys) and the square root is taken only for candidates
// that could enter.  Results are bitwise those of the per-lane kernel
// knn.cu (the same arithmetic, the same (distance, index) order), which
// bounds k by 64 where this one takes k <= 1024.
#include "warp_select.cuh"

namespace {

namespace ws = repro::ws;

template <int D, int K, typename C = ws::Config<D, K, false>>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
knn_ws_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int d, int k,
              bool vec4, float* __restrict__ dist_out, int* __restrict__ idx_out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  constexpr int R = C::R;
  const int row0 = (blockIdx.x * C::kWarps + (threadIdx.x >> 5)) * R;
  ws::WarpSelect<K, C::T> sel[R];
  ws::select_rows<C, D, false>(sel, x, n, y, m, d, k, vec4, row0, smem);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= n) break;
#pragma unroll
    for (int q = 0; q < K / 32; ++q) {
      const int e = q * 32 + lane;
      if (e < k) {
        dist_out[(size_t)row * k + e] = ws::key_dist(sel[r].w[q]);
        idx_out[(size_t)row * k + e] = ws::key_index(sel[r].w[q]);
      }
    }
  }
}

struct Args {
  const float* x;
  const float* y;
  int n, m, d, k;
  float* dist;
  int* idx;
  cudaStream_t stream;
};

template <int D, int K>
struct Launch {
  static int run(const Args& a) {
    using C = ws::Config<D, K, false>;
    const auto kernel = knn_ws_kernel<D, K>;
    const size_t smem = ws::smem_bytes<C, D>();
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = C::kWarps * C::R;
    const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
    kernel<<<(a.n + rows - 1) / rows, C::kThreads, smem, a.stream>>>(a.x, a.y, a.n, a.m, a.d, a.k, vec4,
                                                                       a.dist, a.idx);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x (n, d), y (m, d) row-major f32 on the device; dist_out (n, k) f32 and
// idx_out (n, k) int32.  1 <= k <= min(1024, m), d <= 128.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_knn_ws_f32(const void* x, const void* y, int n, int m, int d, int k, void* dist_out,
                                void* idx_out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || d > repro::kMaxDim || k < 1 || k > ws::kMaxK || k > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, k,
               static_cast<float*>(dist_out), static_cast<int*>(idx_out), static_cast<cudaStream_t>(stream)};
  return ws::dispatch<Launch>(d, k, a);
}
