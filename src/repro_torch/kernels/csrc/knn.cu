// k nearest neighbours (the port of the JAX package's Pallas kernel
// repro/kernels/knn.py::_knn_kernel).
//
// For query row i: the k smallest sqrt(max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0))
// over the rows j of y, ascending, with their indices; equal distances keep
// the lower index first (the order of a stable sort and of jax.lax.top_k).
//
// One warp per query row, as in bubble_cd.cu.  The y table streams through
// shared memory in chunks, once per block of kWarps rows (nothing of size
// (rows, m) is held, and no m cap applies); every lane keeps a sorted
// buffer of its own k smallest (d, j) over the columns it visits in
// ascending order, so a strict '<' keeps the lowest index among equal
// distances.  The 32 buffers are then merged by k rounds of warp-wide
// lexicographic minimum, which yields exactly the first k entries of the
// global (d, j) order.  Each distance is computed once; its square root is
// taken only when the squared distance could enter the buffer.  A row that
// is also in y is exactly 0 from itself: the FMA chains of x.x, y.y and
// x.y are then one chain.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 64;  // per-lane buffer bound; the wrapper raises above it
constexpr int kChunkFloats = 4096;

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int d, int k,
           int chunk, float* __restrict__ dist_out, int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  const int ds = repro::smem_stride(d);
  float* ys = smem;             // chunk x ds staged y rows
  float* yn = ys + chunk * ds;  // chunk norms
  float* xs = yn + chunk;       // kWarps x ds own rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const float inf = __int_as_float(0x7f800000);

  repro::stage_rows(xs, x, row0, kWarps, n, d);
  __syncthreads();
  const float* xw = xs + warp * ds;
  const float xx = repro::dot_chain(xw, xw, d);

  float bd[kMaxK];
  int bj[kMaxK];
  int cnt = 0;       // entries held by this lane
  float thr = inf;   // k-th smallest held, +inf until full
  float thr2 = inf;  // every squared distance whose root is <= thr is below this

  for (int c0 = 0; c0 < m; c0 += chunk) {
    const int cn = min(chunk, m - c0);
    __syncthreads();
    repro::stage_rows(ys, y, c0, cn, m, d);
    __syncthreads();
    for (int j = threadIdx.x; j < cn; j += kThreads) yn[j] = repro::dot_chain(ys + j * ds, ys + j * ds, d);
    __syncthreads();
    if (row >= n) continue;
    for (int j = lane; j < cn; j += 32) {
      const float sq = repro::expanded_sq(xx, yn[j], repro::dot_chain(xw, ys + j * ds, d));
      if (cnt == k && !(sq < thr2)) continue;
      const float dist = sqrtf(sq);
      if (cnt < k || dist < thr) {
        // insertion into the sorted buffer; equal distances stay behind
        // (they carry lower column indices)
        int pos = cnt < k ? cnt : k - 1;
        while (pos > 0 && bd[pos - 1] > dist) {
          bd[pos] = bd[pos - 1];
          bj[pos] = bj[pos - 1];
          --pos;
        }
        bd[pos] = dist;
        bj[pos] = c0 + j;
        if (cnt < k) ++cnt;
        if (cnt == k) {
          thr = bd[k - 1];
          // sqrtf is correctly rounded, so sqrtf(sq) <= thr implies
          // sq < next(thr)^2, rounded up here
          const float up = nextafterf(thr, inf);
          thr2 = __fmul_ru(up, up);
        }
      }
    }
  }
  if (row >= n) return;

  int head = 0;
  for (int t = 0; t < k; ++t) {
    float v = head < cnt ? bd[head] : inf;
    int j = head < cnt ? bj[head] : INT_MAX;
    const int mine = j;
    repro::warp_argmin(v, j);
    if (mine == j) ++head;
    if (lane == 0) {
      dist_out[(size_t)row * k + t] = v;
      idx_out[(size_t)row * k + t] = j;
    }
  }
}

}  // namespace

// x (n, d), y (m, d) row-major f32 on the device; dist_out (n, k) f32 and
// idx_out (n, k) int32.  1 <= k <= min(64, m).  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_knn_f32(const void* x, const void* y, int n, int m, int d, int k,
                             void* dist_out, void* idx_out, void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || d > repro::kMaxDim || k < 1 || k > kMaxK || k > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ds = repro::smem_stride(d);
  int chunk = (kChunkFloats / (ds + 1)) & ~31;
  if (chunk < 32) chunk = 32;
  const size_t smem = sizeof(float) * ((size_t)chunk * (ds + 1) + (size_t)kWarps * ds);
  const int grid = (n + kWarps - 1) / kWarps;
  knn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n, m, d, k, chunk,
      static_cast<float*>(dist_out), static_cast<int*>(idx_out));
  return static_cast<int>(cudaGetLastError());
}
