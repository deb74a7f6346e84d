// The Eq. 6 walk of bubble_cd's strip route (kernels/bubble_cd.py), for
// tables the warp-select kernel does not take (d > 128 or min_pts > 1024).
//
// The wrapper computes a strip of rows' distances to every bubble with the
// pairwise panel (the same bits as the warp-select kernel's), sets each
// row's own entry to exactly 0 and sorts every row stably on distance, so
// equal distances keep the lower index: the (distance, index) order of the
// warp-select key.  Here one warp per row walks the first k = min(min_pts,
// L) entries of that order as bubble_cd_ws.cu does: 32 entries at a time are
// loaded by the lanes in parallel and read by shuffles, and their masses
// are added one __fadd_rn at a time in ascending order up to the crossing
// (torch.cumsum is a parallel scan and would not give these bits).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;

// dist (rows, m) and order (rows, m) int64, row-major: each row sorted.
__global__ void __launch_bounds__(kWarps * 32)
bubble_cd_walk_kernel(const float* __restrict__ dist, const long long* __restrict__ order, int rows, int m, int k,
                      const float* __restrict__ nb, const float* __restrict__ ext, int min_pts, int dim,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* dr = dist + (size_t)row * m;
  const long long* jr = order + (size_t)row * m;
  const float mp = static_cast<float>(min_pts);
  float csum = 0.f, dstar = 0.f, before = 0.f, nb_c = 1.f, ext_c = 0.f;
  float m_last = 0.f, nb_last = 0.f, ext_last = 0.f;
  bool done = false;
  for (int q = 0; q < k && !done; q += 32) {
    const int e = q + lane;
    float d_e = 0.f, nb_e = 0.f, ext_e = 0.f;
    if (e < k) {
      const long long j = jr[e];
      d_e = dr[e];
      nb_e = nb[j];
      ext_e = ext[j];
    }
    const int cnt = min(32, k - q);
    for (int t = 0; t < cnt; ++t) {
      const float m_t = __shfl_sync(kFull, d_e, t);
      const float nb_t = __shfl_sync(kFull, nb_e, t);
      const float ext_t = __shfl_sync(kFull, ext_e, t);
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
  if (lane == 0) out[row] = repro::eq6_core_distance(dstar, before, nb_c, ext_c, mp, dim);
}

}  // namespace

// dist (rows, m) f32 and order (rows, m) int64 on the device, each row
// sorted ascending by (distance, index); nb (L,), ext (L,) f32; out (rows,)
// f32.  1 <= k <= m.  Returns cudaGetLastError() after the launch.
extern "C" int repro_bubble_cd_walk_f32(const void* dist, const void* order, int rows, int m, int k, const void* nb,
                                        const void* ext, int min_pts, int dim, void* out, void* stream) {
  if (rows <= 0 || m <= 0 || k < 1 || k > m || min_pts < 1 || dim < 1) return static_cast<int>(cudaErrorInvalidValue);
  bubble_cd_walk_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const long long*>(order), rows, m, k,
      static_cast<const float*>(nb), static_cast<const float*>(ext), min_pts, dim, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
