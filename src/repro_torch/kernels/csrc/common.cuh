// Shared helpers of the port's distance kernels (plain C interface, sm_90a).
//
// Every distance here is the expanded f32 form of the JAX package's Pallas
// kernels, max(|x|^2 + |y|^2 - 2 x.y, 0), with each dot product and norm an
// explicit round-to-nearest FMA chain over the feature axis in ascending
// order.  The chain is a function of the two rows' values only, so exact
// duplicate rows give bitwise equal distances wherever they sit in a tile,
// and index ties resolve by the lowest index exactly as in the plain
// versions (kernels/ref.py).  No tensor cores and no TF32: d is small and
// the contracts are f32.
#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace repro {

constexpr int kMaxDim = 128;  // feature widths of the warp-select and per-lane kernels

// Odd row stride in shared memory: lanes reading consecutive rows at the
// same feature hit distinct banks.
__host__ __device__ inline int smem_stride(int d) { return d | 1; }

// acc continued over a[0..d) . b[0..d): a chain cut into slices and
// continued slice by slice gives the bits of the uncut chain.
__device__ __forceinline__ float dot_chain(const float* a, const float* b, int d, float acc = 0.f) {
  for (int k = 0; k < d; ++k) acc = __fmaf_rn(a[k], b[k], acc);
  return acc;
}

// max((xx + yy) - 2 xy, 0); 2 xy is exact, so no contraction can change it.
__device__ __forceinline__ float expanded_sq(float xx, float yy, float xy) {
  return fmaxf(__fsub_rn(__fadd_rn(xx, yy), __fmul_rn(2.f, xy)), 0.f);
}

// Stage features [k0, k0 + w) of rows [r0, r0 + rows) of a row-major
// (n, d) table into shared memory with row stride ds (default
// smem_stride(d), the whole row); rows past n are zero.  Call with the
// whole block; the caller synchronises.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0, int rows,
                                           int n, int d, int k0 = 0, int w = -1, int ds = -1) {
  if (w < 0) w = d;
  if (ds < 0) ds = smem_stride(d);
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < rows * w; t += nthreads) {
    const int r = t / w, k = t - r * w;
    dst[r * ds + k] = (r0 + r < n) ? src[(size_t)(r0 + r) * d + k0 + k] : 0.f;
  }
}

// Asynchronous global -> shared copies of 16 or 4 bytes (cp.async); an
// invalid copy reads nothing and zero-fills its destination.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Lexicographic (value, index) minimum across a warp; every lane returns
// the winner.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// x**(1/dim): repeated correctly rounded sqrt for power-of-two dims, powf
// otherwise (kernels/ref.py::dim_root).
__device__ __forceinline__ float dim_root(float x, int dim) {
  if (dim >= 1 && (dim & (dim - 1)) == 0) {
    for (int p = dim; p > 1; p >>= 1) x = sqrtf(x);
    return x;
  }
  return powf(x, 1.0f / static_cast<float>(dim));
}

// Eq. 6 from the walk's crossing: C the crossing bubble (mass nb_c, extent
// ext_c) at distance dstar with mass `before` ahead of it,
//   d* + dim_root(clip(max(min_pts - before, 1), 0, n_C) / n_C, dim) * extent_C.
__device__ __forceinline__ float eq6_core_distance(float dstar, float before, float nb_c, float ext_c, float mp,
                                                   int dim) {
  const float n_c = fmaxf(nb_c, 1.f);
  const float k_resid = fminf(fmaxf(fmaxf(__fsub_rn(mp, before), 1.f), 0.f), n_c);
  return __fadd_rn(dstar, __fmul_rn(dim_root(__fdiv_rn(k_resid, n_c), dim), ext_c));
}

// Opt in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
