// Eq. 6 bubble core distances (the port of the JAX package's Pallas kernel
// repro/kernels/bubble_cd.py::_bubble_cd_kernel), on the warp-select core.
//
// For bubble row i: walk the other bubbles in ascending (distance, index)
// order -- self at distance 0 -- until the cumulative mass n_b reaches
// min_pts; with C the crossing bubble, d* its distance and `before` the mass
// ahead of it,
//   cd_i = d* + dim_root(clip(max(min_pts - before, 1), 0, n_C) / n_C, dim) * extent_C.
// Every real bubble has n_b >= 1, so the walk ends within the first
// k = min(min_pts, L) entries of that order.
//
// Bound on the H100: operations, the L(L-1)/2·d FMAs of every unordered
// pair (each pair is computed twice here, once per row).  warp_select.cuh
// finds each row's first k entries of the (distance, index) order with the
// rows in registers and the table streamed once per block; the pair
// (row, row) is set to exactly 0, not computed.  The Eq. 6 scan then walks
// those entries in ascending order, one __fadd_rn at a time, as the
// per-lane kernel bubble_cd.cu does: 32 entries at a time are read from the
// warp queue's registers by shuffles, with their masses and extents loaded
// by the lanes in parallel.  So the f32 sum order, the crossing bubble and
// the output are bitwise that kernel's, which bounds min_pts by 64 where
// this one takes min_pts <= 1024.
//
// A launch covers the rows [row0, row0 + rows) against all L columns (the
// sharded offline pass gives each shard its strip): rows are indexed
// globally, so the self pair and every element's arithmetic are those of
// the launch over all rows, and a strip's outputs are bit for bit the same
// rows of it.
#include "warp_select.cuh"

namespace {

namespace ws = repro::ws;

template <int D, int K, typename C = ws::Config<D, K, true>>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
bubble_cd_ws_kernel(const float* __restrict__ rep, const float* __restrict__ nb, const float* __restrict__ ext,
                    int L, int d, int first, int end, int min_pts, int dim, bool vec4, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  constexpr int R = C::R;
  const int row0 = first + (blockIdx.x * C::kWarps + (threadIdx.x >> 5)) * R;
  const int k = min(min_pts, L);
  ws::WarpSelect<K, C::T> sel[R];
  ws::select_rows<C, D, true>(sel, rep, end, rep, L, d, k, vec4, row0, smem);

  const float mp = static_cast<float>(min_pts);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    if (row >= end) break;
    float csum = 0.f, dstar = 0.f, before = 0.f, nb_c = 1.f, ext_c = 0.f;
    float m_last = 0.f, nb_last = 0.f, ext_last = 0.f;
    bool done = false;
#pragma unroll
    for (int q = 0; q < K / 32; ++q) {
      if (done || q * 32 >= k) break;
      const int e = q * 32 + lane;
      const ws::Key key = sel[r].w[q];
      const float dist = ws::key_dist(key);
      float nb_e = 0.f, ext_e = 0.f;
      if (e < k) {
        nb_e = nb[ws::key_index(key)];
        ext_e = ext[ws::key_index(key)];
      }
      const int cnt = min(32, k - q * 32);
#pragma unroll 1
      for (int t = 0; t < cnt; ++t) {
        const float m_t = __shfl_sync(ws::kFull, dist, t);
        const float nb_t = __shfl_sync(ws::kFull, nb_e, t);
        const float ext_t = __shfl_sync(ws::kFull, ext_e, t);
        const float new_csum = __fadd_rn(csum, nb_t);
        if (new_csum >= mp) {
          dstar = m_t;
          before = csum;
          nb_c = nb_t;
          ext_c = ext_t;
          done = true;
          break;
        }
        csum = new_csum;
        m_last = m_t;
        nb_last = nb_t;
        ext_last = ext_t;
      }
    }
    if (!done) {  // mass below min_pts: the last entry plays the crossing bubble
      dstar = m_last;
      before = __fsub_rn(csum, nb_last);
      nb_c = nb_last;
      ext_c = ext_last;
    }
    if (lane == 0) out[row - first] = repro::eq6_core_distance(dstar, before, nb_c, ext_c, mp, dim);
  }
}

struct Args {
  const float* rep;
  const float* nb;
  const float* ext;
  int L, d, row0, rows, min_pts, dim;
  float* out;
  cudaStream_t stream;
};

template <int D, int K>
struct Launch {
  static int run(const Args& a) {
    using C = ws::Config<D, K, true>;
    const auto kernel = bubble_cd_ws_kernel<D, K>;
    const size_t smem = ws::smem_bytes<C, D>();
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int rows = C::kWarps * C::R;
    const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.rep) % 16 == 0;
    kernel<<<(a.rows + rows - 1) / rows, C::kThreads, smem, a.stream>>>(
        a.rep, a.nb, a.ext, a.L, a.d, a.row0, a.row0 + a.rows, a.min_pts, a.dim, vec4, a.out);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// rep (L, d), nb (L,), ext (L,) f32 on the device; out (rows,) f32, the
// rows [row0, row0 + rows) of the table (0 <= row0, 1 <= rows, row0 + rows
// <= L).  1 <= min_pts <= 1024, d <= 128.  Returns cudaGetLastError() after
// the launch.
extern "C" int repro_bubble_cd_ws_f32(const void* rep, const void* nb, const void* ext, int L, int d, int row0,
                                      int rows, int min_pts, int dim, void* out, void* stream) {
  if (L <= 0 || d <= 0 || d > repro::kMaxDim || min_pts < 1 || min_pts > ws::kMaxK || dim < 1 || row0 < 0 ||
      rows < 1 || row0 > L - rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(rep), static_cast<const float*>(nb), static_cast<const float*>(ext),
               L, d, row0, rows, min_pts, dim, static_cast<float*>(out), static_cast<cudaStream_t>(stream)};
  return ws::dispatch<Launch>(d, min(min_pts, L), a);
}
