// The distance panel: one Hopper core for the pairwise and mutual_reach
// kernels (the ports of the JAX package's Pallas kernels
// repro/kernels/pairwise.py::_pairwise_kernel and
// repro/kernels/mutual_reach.py::_mutual_reach_kernel), redesigned from the
// 64 x 64 tile of dist_tile.cuh (pairwise.cu, mutual_reach.cu), whose bits
// it keeps.
//
//   pairwise:     out[r, c] = max(|x_r|^2 + |y_c|^2 - 2 x_r.y_c, 0)
//   mutual_reach: out[r, c] = max(sqrt(that), cd_x[r], cd_y[c]), the global
//                 diagonal 0 when zero_diag, and +inf on every row and
//                 column at or past n_valid (the offline pass's pad mask);
//                 x may be the rows row0 .. of the table (a shard's strip of
//                 the sharded offline pass): the diagonal and the row mask
//                 read the global row row0 + r, every element's arithmetic
//                 is the same in any launch, so a strip is bit for bit the
//                 same rows of the whole matrix
//
// Bound on the H100: the n·m·4 output bytes at the main path's d = 16, the
// n·m·d FMAs from d ~ 64 on.  The 64 x 64 tile issued 10 shared loads per
// 16 FMAs, recomputed every row norm in every tile on 128 threads between
// two barriers, and computed the pad mask's distances before overwriting
// them.  Here:
//
//  * Norms once per call: dist_norms_kernel chains each row's norm
//    (dot_chain's ascending __fmaf_rn order) into a scratch vector, each
//    side padded with zeros to whole tiles; the epilogue reads them as
//    16-byte loads.
//  * Register outer products: a block of 256 threads owns a 128 x 128
//    output tile, each thread 8 x 8 outputs (rows ty*4 + {0..3} and
//    64 + ty*4 + {0..3}, the same for columns with tx).  The x and y panels
//    sit feature-major in shared memory, so per feature a thread reads its
//    8 rows and 8 columns as four ld.shared.v4 (a warp covers 4 x 8
//    threads, so each load asks for at most 128 distinct bytes) and issues
//    64 FMAs: 16 FMAs per load.
//  * A two-stage cp.async ring of kKS features: 4-byte copies (any d and
//    alignment, zero-filled past n, m and d; an FMA of two zeros leaves an
//    accumulator's bits unchanged), the next stage's copies in flight while
//    the current one is multiplied and its tile stored; one barrier per
//    stage.  d > kKS walks the features slice by slice with the
//    accumulators in registers, so every chain is the unsliced one.
//  * Persistent blocks, sized by occupancy (repro_dist_panel_plan), take
//    tiles blockIdx.x, blockIdx.x + gridDim.x, ... in row-panel order and
//    store each tile straight from registers (st.global.v4 where every row
//    starts 16-byte aligned, scalar stores otherwise) while the next
//    tile's copies land.
//  * mutual_reach: a tile wholly at or past n_valid is written +inf with
//    no copies and no arithmetic; only tiles that cross n_valid or the
//    diagonal compare per element.
//
// The arithmetic is common.cuh's exactly (dot_chain's chain for every dot
// product and norm, expanded_sq, a correctly rounded sqrtf, the same fmaxf
// order as mutual_reach.cu), so every output is bitwise the tile kernels'.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kKS = 16;              // features per ring stage
constexpr int kSX = kBM + 4;         // floats per staged feature of the x panel
constexpr int kSY = kBN + 4;         // ... of the y panel
constexpr int kStage = kKS * (kSX + kSY);
constexpr size_t kSmemBytes = sizeof(float) * 2 * kStage;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

struct Tiles {
  int n, m, cols, count;
  __device__ __forceinline__ int r0(int t) const { return t / cols * kBM; }
  __device__ __forceinline__ int c0(int t) const { return t % cols * kBN; }
};

// Start the copies of features [k0, k0 + kKS) of tile t's x rows and y rows
// into one ring stage, feature-major; zero past n, m and d.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ x, const float* __restrict__ y,
                                      const Tiles& T, int t, int k0, int d) {
  const int k = threadIdx.x % kKS, row = threadIdx.x / kKS;
  const int r0 = T.r0(t), c0 = T.c0(t);
  const bool kin = k0 + k < d;
#pragma unroll
  for (int j = 0; j < kBM / (kThreads / kKS); ++j) {
    const int r = row + j * (kThreads / kKS);
    const bool ok = kin && r0 + r < T.n;
    repro::cp_async4(buf + k * kSX + r, ok ? x + (size_t)(r0 + r) * d + k0 + k : x, ok);
  }
  float* ys = buf + kKS * kSX;
#pragma unroll
  for (int j = 0; j < kBN / (kThreads / kKS); ++j) {
    const int c = row + j * (kThreads / kKS);
    const bool ok = kin && c0 + c < T.m;
    repro::cp_async4(ys + k * kSY + c, ok ? y + (size_t)(c0 + c) * d + k0 + k : y, ok);
  }
  repro::cp_async_commit();
}

// acc[i][j] += x_row(i) * y_col(j) over the stage's first 4·groups features,
// in ascending order.
__device__ __forceinline__ void multiply(float (&acc)[8][8], const float* buf, int tx, int ty, int groups) {
  const float* xs = buf + ty * 4;
  const float* ys = buf + kKS * kSX + tx * 4;
#pragma unroll
  for (int g = 0; g < kKS / 4; ++g) {
    if (g >= groups) break;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * g + u;
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kSX);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kSX + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(ys + k * kSY);
      const float4 b1 = *reinterpret_cast<const float4*>(ys + k * kSY + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
}

// The thread's row i / column j of a tile, relative to its origin.
__device__ __forceinline__ int lane_row(int ty, int i) { return (i & 4) * 16 + ty * 4 + (i & 3); }

// Row r of the output at the thread's 8 columns c (c0 + tx*4 + {0..3},
// c0 + 64 + tx*4 + {0..3}); vec: m % 4 == 0 and out 16-byte aligned.
__device__ __forceinline__ void store_row(float* __restrict__ out, int r, int c, int m, bool vec,
                                          const float (&v)[8]) {
  float* p = out + (size_t)r * m;
#pragma unroll
  for (int h = 0; h < 2; ++h, c += 64) {
    if (vec) {
      if (c < m) *reinterpret_cast<float4*>(p + c) = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < m) p[c + q] = v[4 * h + q];
    }
  }
}

// A mutual_reach tile wholly at or past n_valid: +inf, nothing computed.
__device__ __forceinline__ void store_inf(float* __restrict__ out, const Tiles& T, int t, int tx, int ty,
                                          bool vec) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = inf();
  const int r0 = T.r0(t), c = T.c0(t) + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + lane_row(ty, i);
    if (r < T.n) store_row(out, r, c, T.m, vec, v);
  }
}

struct Args {
  const float* x;
  const float* y;
  const float* norms;  // x's rows, then y's from rows_pad on (set by launch)
  const float* cdx;    // mutual_reach only
  const float* cdy;
  int n, m, d, zero_diag, n_valid, row0, rows_pad;
  bool vec;
  float* out;
};

template <bool kMutual>
__device__ __forceinline__ void epilogue(const Args& a, const Tiles& T, int t, int tx, int ty,
                                         const float (&acc)[8][8]) {
  const int r0 = T.r0(t), c0 = T.c0(t);
  float yn[8], cc[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = *reinterpret_cast<const float4*>(a.norms + a.rows_pad + c0 + 64 * h + tx * 4);
    yn[4 * h] = v.x, yn[4 * h + 1] = v.y, yn[4 * h + 2] = v.z, yn[4 * h + 3] = v.w;
  }
  if (kMutual) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane_row(tx, j);
      cc[j] = c < a.m ? a.cdy[c] : 0.f;
    }
  }
  // only tiles that cross n_valid or the diagonal compare per element (global rows)
  const int g0 = a.row0 + r0;
  const bool edge = kMutual && (g0 + kBM > a.n_valid || c0 + kBN > a.n_valid ||
                                (a.zero_diag && g0 < c0 + kBN && c0 < g0 + kBM));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + lane_row(ty, i);
    if (r >= a.n) continue;
    const float xn = a.norms[r];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = repro::expanded_sq(xn, yn[j], acc[i][j]);
    if (kMutual) {
      const float cr = a.cdx[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = fmaxf(sqrtf(v[j]), fmaxf(cr, cc[j]));
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + lane_row(tx, j);
          if (a.zero_diag && a.row0 + r == c) v[j] = 0.f;
          if (a.row0 + r >= a.n_valid || c >= a.n_valid) v[j] = inf();
        }
      }
    }
    store_row(a.out, r, c0 + tx * 4, a.m, a.vec, v);
  }
}

template <bool kMutual>
__global__ void __launch_bounds__(kThreads, 2) dist_panel_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int cols = (a.m + kBN - 1) / kBN;
  const Tiles T{a.n, a.m, cols, (a.n + kBM - 1) / kBM * cols};
  const int slices = (a.d + kKS - 1) / kKS;
  // a mutual_reach tile wholly at or past n_valid is only written
  auto pad = [&](int t) { return kMutual && (a.row0 + T.r0(t) >= a.n_valid || T.c0(t) >= a.n_valid); };

  int t = blockIdx.x;
  for (; t < T.count && pad(t); t += gridDim.x) store_inf(a.out, T, t, tx, ty, a.vec);
  if (t >= T.count) return;
  int q = 0;  // the feature slice of tile t in this step
  stage(smem, a.x, a.y, T, t, 0, a.d);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0;; ++s) {
    int t1 = t, q1 = q + 1;  // the next step: the next slice, or the next tile to compute
    if (q1 == slices) {
      q1 = 0;
      for (t1 = t + gridDim.x; t1 < T.count && pad(t1); t1 += gridDim.x) {
      }
    }
    repro::cp_async_wait_all();
    __syncthreads();  // step s has landed; every warp is done with step s - 1's buffer
    if (t1 < T.count) stage(smem + ((s + 1) & 1) * kStage, a.x, a.y, T, t1, q1 * kKS, a.d);
    multiply(acc, smem + (s & 1) * kStage, tx, ty, (min(kKS, a.d - q * kKS) + 3) / 4);
    if (q1 == 0) {
      epilogue<kMutual>(a, T, t, tx, ty, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int tp = t + gridDim.x; tp < min(t1, T.count); tp += gridDim.x) store_inf(a.out, T, tp, tx, ty, a.vec);
    }
    if (t1 >= T.count) break;
    t = t1;
    q = q1;
  }
}

// Each row's norm, dot_chain over its d features; rows past n (m) up to the
// padded counts are 0.
__global__ void dist_norms_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int d,
                                  int rows_pad, int cols_pad, float* __restrict__ norms) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows_pad + cols_pad) return;
  const bool is_x = i < rows_pad;
  const int r = is_x ? i : i - rows_pad;
  const float* row = (is_x ? x : y) + (size_t)r * d;
  norms[i] = r < (is_x ? n : m) ? repro::dot_chain(row, row, d) : 0.f;
}

int launch(bool mutual, Args a, int grid, void* norms, cudaStream_t stream) {
  if (a.n <= 0 || a.m <= 0 || a.d <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  a.rows_pad = (a.n + kBM - 1) / kBM * kBM;
  const int cols_pad = (a.m + kBN - 1) / kBN * kBN;
  a.norms = static_cast<const float*>(norms);
  dist_norms_kernel<<<(a.rows_pad + cols_pad + 255) / 256, 256, 0, stream>>>(a.x, a.y, a.n, a.m, a.d, a.rows_pad,
                                                                           cols_pad, static_cast<float*>(norms));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mutual) {
    dist_panel_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(a);
  } else {
    dist_panel_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The blocks of the pairwise (mutual = 0) or mutual_reach (1) panel kernel
// one SM holds at once; the wrapper sizes the persistent grid by it.
// Returns a CUDA error code.
extern "C" int repro_dist_panel_plan(int mutual, int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mutual ? dist_panel_kernel<true> : dist_panel_kernel<false>, kThreads, kSmemBytes));
}

// x (n, d), y (m, d) row-major f32 on the device; out (n, m) f32 with row
// stride m; norms: scratch of (ceil(n / 128) + ceil(m / 128)) * 128 floats.
// grid persistent blocks; vec: m % 4 == 0 and out 16-byte aligned.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_pairwise_panel_f32(const void* x, const void* y, int n, int m, int d, int grid, int vec,
                                        void* norms, void* out, void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y), nullptr, nullptr, nullptr,
               n, m, d, 0, 0, 0, 0, vec != 0, static_cast<float*>(out)};
  return launch(false, a, grid, norms, static_cast<cudaStream_t>(stream));
}

// As repro_pairwise_panel_f32, with cdx (n,), cdy (m,) f32: Eq. 7, the
// diagonal 0 when zero_diag, rows and columns >= n_valid +inf (pass
// n_valid >= max(row0 + n, m) for no mask); x's row r is the table's row
// row0 + r (row0 >= 0).
extern "C" int repro_mutual_reach_panel_f32(const void* x, const void* y, const void* cdx, const void* cdy, int n,
                                            int m, int d, int zero_diag, int n_valid, int row0, int grid, int vec,
                                            void* norms, void* out, void* stream) {
  if (row0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y), nullptr,
               static_cast<const float*>(cdx), static_cast<const float*>(cdy), n, m, d, zero_diag, n_valid, row0,
               0, vec != 0, static_cast<float*>(out)};
  return launch(true, a, grid, norms, static_cast<cudaStream_t>(stream));
}
