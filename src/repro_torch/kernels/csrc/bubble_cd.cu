// Eq. 6 bubble core distances (the port of the JAX package's Pallas kernel
// repro/kernels/bubble_cd.py::_bubble_cd_kernel).
//
// For bubble row i: walk the other bubbles in ascending (distance, index)
// order -- self at distance 0 -- until the cumulative mass n_b reaches
// min_pts; with C the crossing bubble, d* its distance and `before` the mass
// ahead of it,
//   cd_i = d* + dim_root(clip(max(min_pts - before, 1), 0, n_C) / n_C, dim) * extent_C.
// Every real bubble has n_b >= 1, so the walk ends within the first min_pts
// entries of that order.
//
// One warp per row.  The rep table streams through shared memory in chunks
// (nothing of size (rows, L) is held, and no L cap applies); every lane
// keeps a sorted buffer of its own k = min(min_pts, L) smallest (d, j) over
// the columns it visits in ascending order, so a strict '<' keeps the lowest
// index among equal distances.  The 32 buffers are then merged by k rounds
// of warp-wide lexicographic minimum, which yields exactly the first k
// entries of the global (d, j) order; every lane runs the Eq. 6 scan on
// them and lane 0 writes.  Distances are computed once per pair.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxMinPts = 64;  // per-lane buffer bound; the wrapper raises above it
constexpr int kChunkFloats = 4096;

__global__ void __launch_bounds__(kThreads)
bubble_cd_kernel(const float* __restrict__ rep, const float* __restrict__ nb,
                 const float* __restrict__ ext, int L, int d, int min_pts, int dim, int chunk,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int ds = repro::smem_stride(d);
  float* rs = smem;             // chunk x ds staged reps
  float* rr = rs + chunk * ds;  // chunk norms
  float* xs = rr + chunk;       // kWarps x ds own rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kWarps;
  const int row = row0 + warp;
  const int k = min(min_pts, L);

  repro::stage_rows(xs, rep, row0, kWarps, L, d);
  __syncthreads();
  const float* xw = xs + warp * ds;
  const float xx = repro::dot_chain(xw, xw, d);

  float bd[kMaxMinPts];
  int bj[kMaxMinPts];
  int cnt = 0;                                 // entries held by this lane
  float thr = __int_as_float(0x7f800000);      // k-th smallest held, +inf until full

  for (int c0 = 0; c0 < L; c0 += chunk) {
    const int cn = min(chunk, L - c0);
    __syncthreads();
    repro::stage_rows(rs, rep, c0, cn, L, d);
    __syncthreads();
    for (int j = threadIdx.x; j < cn; j += kThreads) rr[j] = repro::dot_chain(rs + j * ds, rs + j * ds, d);
    __syncthreads();
    if (row >= L) continue;
    for (int j = lane; j < cn; j += 32) {
      const int col = c0 + j;
      const float dist = (col == row)
          ? 0.f
          : sqrtf(repro::expanded_sq(xx, rr[j], repro::dot_chain(xw, rs + j * ds, d)));
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
        bj[pos] = col;
        if (cnt < k) ++cnt;
        if (cnt == k) thr = bd[k - 1];
      }
    }
  }
  if (row >= L) return;

  // merge: k rounds of warp-wide lexicographic min over the lanes' heads,
  // each feeding one step of the Eq. 6 cumulative-mass scan
  const float mp = static_cast<float>(min_pts);
  int head = 0;
  float csum = 0.f, dstar = 0.f, before = 0.f, nb_c = 1.f, ext_c = 0.f;
  float m = 0.f, nb_j = 0.f, ext_j = 0.f;
  bool done = false;
  for (int t = 0; t < k; ++t) {
    float v = head < cnt ? bd[head] : __int_as_float(0x7f800000);
    int j = head < cnt ? bj[head] : INT_MAX;
    const int mine = j;
    repro::warp_argmin(v, j);
    if (mine == j) ++head;
    m = v;
    nb_j = nb[j];
    ext_j = ext[j];
    const float new_csum = __fadd_rn(csum, nb_j);
    if (!done && new_csum >= mp) {
      dstar = m;
      before = csum;
      nb_c = nb_j;
      ext_c = ext_j;
      done = true;
    }
    csum = new_csum;
  }
  if (!done) {  // mass below min_pts: the last entry plays the crossing bubble
    dstar = m;
    before = __fsub_rn(csum, nb_j);
    nb_c = nb_j;
    ext_c = ext_j;
  }
  if (lane == 0) out[row] = repro::eq6_core_distance(dstar, before, nb_c, ext_c, mp, dim);
}

}  // namespace

// rep (L, d), nb (L,), ext (L,) f32 on the device; out (L,) f32.
// 1 <= min_pts <= 64.  Returns cudaGetLastError() after the launch.
extern "C" int repro_bubble_cd_f32(const void* rep, const void* nb, const void* ext, int L, int d,
                                   int min_pts, int dim, void* out, void* stream) {
  if (L <= 0 || d <= 0 || d > repro::kMaxDim || min_pts < 1 || min_pts > kMaxMinPts || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ds = repro::smem_stride(d);
  int chunk = (kChunkFloats / (ds + 1)) & ~31;
  if (chunk < 32) chunk = 32;
  const size_t smem = sizeof(float) * ((size_t)chunk * (ds + 1) + (size_t)kWarps * ds);
  const int grid = (L + kWarps - 1) / kWarps;
  bubble_cd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rep), static_cast<const float*>(nb), static_cast<const float*>(ext),
      L, d, min_pts, dim, chunk, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
