// Nearest-representative assignment (the port of the JAX package's Pallas
// kernel repro/kernels/assign.py::_assign_kernel), redesigned for Hopper.
//
// For each query row: the lowest index j attaining min_j max(|x|^2 + |r_j|^2
// - 2 x.r_j, 0), and optionally sqrt of that minimum.
//
// Bound on the H100: operations, n·L·d FMAs; the inputs are a few MB.  The
// per-lane kernel (assign.cu) read every feature of every rep and four
// query features from shared memory per four FMAs, staged each chunk
// synchronously, and ran 32 rows per block.  Here, on warp_select.cuh's
// pattern:
//
//  * Query rows in registers.  A warp owns R rows, zero-padded from d to
//    the template width D in {16, 32, 64, 128}; an FMA of two zeros leaves
//    the accumulator's bits unchanged.
//  * The rep table streams through a double-buffered cp.async ring of CH
//    rows (ws::stage_chunk), each chunk's norms computed once by the block,
//    +inf past the slice's last rep, so a padded column never wins.  Each
//    lane reads its rep row as 16-byte loads that feed R·D FMAs.
//  * L split across blocks.  Where the row blocks alone leave the card
//    under-filled (the serve path's 4096-row chunks), blockIdx.y takes a
//    slice of L; each slice writes its winner as the 64-bit key
//    (bits of sq) << 32 | j, and a second small kernel takes the minimum
//    key per row.  sq >= +0, so the key order is the (sq, index) order: the
//    result does not depend on how L was cut, and no atomics are used.
//  * d > 128 (the wide route): the query rows and the rep chunk are staged
//    together in feature slices of 128, the query rows read by broadcast,
//    and each lane keeps its partial dots and norms in registers across
//    slices, so every chain still runs over the features in ascending
//    order.
//
// The arithmetic is common.cuh's exactly (dot_chain's ascending __fmaf_rn
// chain, expanded_sq), and within a lane the columns are visited in
// ascending order with a strict '<', every lane starting from its first
// column at +inf: the result is the lexicographic (sq, index) minimum, so
// indices and distances are bitwise the per-lane kernel's.
#include "warp_select.cuh"

namespace {

namespace ws = repro::ws;
using ws::Key;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

constexpr int kChunkFloats = 24576;  // one buffer of the rep ring (96 KB)

// Launch shape per padded width D: rows per warp, warps per block, columns
// a lane takes per step, blocks per SM the registers must allow, reps per
// ring buffer (a multiple of 64, stride SD = D + 4 and a norm each).  At
// D = 16 (the main path) chosen among variants timed on the H100 (PERF.md):
// R = 8 rows (212 registers, one block of 8 warps per SM) beat R = 4 with
// two blocks per SM, 4-warp blocks and two columns per step; a 1152-rep
// chunk (kChunkFloats) beat 384 by fewer barriers, and the column loop
// unrolled by two beat no unrolling.
template <int D>
struct Shape {
  static constexpr int R = D <= 16 ? 8 : (D <= 64 ? 2 : 1);
  static constexpr int kWarps = 8;
  static constexpr int kCols = 1;
  static constexpr int kMinBlocks = 1;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kWarps * R;
  static constexpr int SD = ws::Ring<D>::SD;
  static constexpr int CH = (kChunkFloats / (SD + 1)) & ~63;
  static constexpr size_t kSmemFloats = 2 * (size_t)CH * (SD + 1);
};

// The wide route (d > 128): rows per warp, warps per block, reps per chunk
// (two columns per lane), features per slice and the staged row stride.
struct Wide {
  static constexpr int R = 4;
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kWarps * R;
  static constexpr int CH = 64;
  static constexpr int W = 128;
  static constexpr int SD = W + 4;
  static constexpr int kStage = (CH + kRows) * SD;  // floats of one ring stage
};

// Norms of the staged rows (dot_chain over the padded width: the same
// bits); rows at or past `valid` are +inf.
template <int D, int CH, int kThreads>
__device__ __forceinline__ void masked_norms(const float* rows, float* norms, int valid) {
  constexpr int SD = ws::Ring<D>::SD;
  for (int j = threadIdx.x; j < CH; j += kThreads) {
    const float4* p = reinterpret_cast<const float4*>(rows + j * SD);
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < D / 4; ++g) {
      const float4 v = p[g];
      acc = __fmaf_rn(v.x, v.x, acc);
      acc = __fmaf_rn(v.y, v.y, acc);
      acc = __fmaf_rn(v.z, v.z, acc);
      acc = __fmaf_rn(v.w, v.w, acc);
    }
    norms[j] = j < valid ? acc : inf();
  }
}

// The row's winner: the slice's key into part (split L), or the outputs.
__device__ __forceinline__ void emit(float best, int bidx, int row, int n, Key* part, int* idx_out,
                                     float* dist_out) {
  if (part != nullptr) {
    part[(size_t)blockIdx.y * n + row] = ws::make_key(best, bidx);
  } else {
    idx_out[row] = bidx;
    if (dist_out != nullptr) dist_out[row] = sqrtf(best);
  }
}

// Rows row0 .. row0 + R - 1 of this warp against reps [c_begin, c_end),
// c_begin = blockIdx.y * span.
template <int D, typename S = Shape<D>>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
assign_ws_kernel(const float* __restrict__ x, const float* __restrict__ reps, int n, int L, int d, int span,
                 bool vec4, int* __restrict__ idx_out, float* __restrict__ dist_out, Key* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = S::R, COLS = S::kCols, NT = S::kThreads;
  constexpr int SD = S::SD, CH = S::CH;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * S::kWarps + (threadIdx.x >> 5)) * R;
  const int c_begin = blockIdx.y * span, c_end = min(L, c_begin + span);
  float* rows_buf = smem;                // 2 x CH x SD
  float* norm_buf = smem + 2 * CH * SD;  // 2 x CH

  ws::stage_chunk<D, NT, CH>(rows_buf, reps, c_begin, c_end, d, vec4);

  float xr[R][D], xx[R], best[R];
  int bidx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int f = 0; f < D; ++f) xr[r][f] = (i < n && f < d) ? x[(size_t)i * d + f] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int f = 0; f < D; ++f) acc = __fmaf_rn(xr[r][f], xr[r][f], acc);
    xx[r] = acc;
    best[r] = inf();
    bidx[r] = c_begin + lane < c_end ? c_begin + lane : INT_MAX;  // this lane's first column
  }

  ws::cp_async_wait_all();
  __syncthreads();
  masked_norms<D, CH, NT>(rows_buf, norm_buf, c_end - c_begin);
  __syncthreads();

  const int nchunks = (c_end - c_begin + CH - 1) / CH;
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1;
    const int c0 = c_begin + c * CH, cn = min(CH, c_end - c0);
    if (c + 1 < nchunks) ws::stage_chunk<D, NT, CH>(rows_buf + (b ^ 1) * CH * SD, reps, c0 + CH, c_end, d, vec4);
    // columns past cn (< CH, a multiple of 64) are staged zeros at norm +inf
    const float4* yp = reinterpret_cast<const float4*>(rows_buf + b * CH * SD + lane * SD);
    const float* np = norm_buf + b * CH + lane;
#pragma unroll 2
    for (int j0 = 0; j0 < cn; j0 += 32 * COLS, yp += 32 * COLS * (SD / 4), np += 32 * COLS) {
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
        for (int g = 0; g < D / 4; ++g) {
          const float4 v = yp[u * 32 * (SD / 4) + g];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r] = __fmaf_rn(xr[r][4 * g], v.x, acc[r]);
            acc[r] = __fmaf_rn(xr[r][4 * g + 1], v.y, acc[r]);
            acc[r] = __fmaf_rn(xr[r][4 * g + 2], v.z, acc[r]);
            acc[r] = __fmaf_rn(xr[r][4 * g + 3], v.w, acc[r]);
          }
        }
        const float yn = np[32 * u];
        const int j = c0 + j0 + 32 * u + lane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sq = repro::expanded_sq(xx[r], yn, acc[r]);
          if (sq < best[r]) {
            best[r] = sq;
            bidx[r] = j;
          }
        }
      }
    }
    ws::cp_async_wait_all();
    __syncthreads();  // chunk c + 1 has landed; every warp is done with buffer b
    if (c + 1 < nchunks) {
      masked_norms<D, CH, NT>(rows_buf + (b ^ 1) * CH * SD, norm_buf + (b ^ 1) * CH, c_end - c0 - CH);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    repro::warp_argmin(best[r], bidx[r]);
    const int row = row0 + r;
    if (lane == 0 && row < n) emit(best[r], bidx[r], row, n, part, idx_out, dist_out);
  }
}

// Start the copies of feature slice [k0, k0 + W) of reps [c0, c0 + CH) and
// of the block's query rows [q0, q0 + kRows) into one ring stage; zero past
// c_end, n and d.  vec4: d % 4 == 0 and both tables 16-byte aligned.
__device__ __forceinline__ void stage_wide(float* buf, const float* __restrict__ reps, const float* __restrict__ x,
                                           int c0, int c_end, int q0, int n, int d, int k0, bool vec4) {
  constexpr int G = Wide::W / 4, ROWS = Wide::CH + Wide::kRows;
  for (int t = threadIdx.x; t < ROWS * G; t += Wide::kThreads) {
    const int r = t / G, f = (t % G) * 4;
    const bool is_rep = r < Wide::CH;
    const int row = is_rep ? c0 + r : q0 + r - Wide::CH;
    const bool live = is_rep ? row < c_end : row < n;
    const float* src = (is_rep ? reps : x) + (live ? (size_t)row * d + k0 + f : 0);
    float* dst = buf + r * Wide::SD + f;
    if (vec4) {
      const bool ok = live && k0 + f < d;
      ws::cp_async16(dst, ok ? src : reps, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live && k0 + f + e < d;
        ws::cp_async4(dst + e, ok ? src + e : reps, ok);
      }
    }
  }
  ws::cp_async_commit();
}

// d > 128: one ring stage per (rep chunk, feature slice).  Lane l owns
// columns l and l + 32 of each chunk and carries their dots with the warp's
// R rows, and their norms, across the chunk's slices; the rows' norms are
// chained during the first chunk.
__global__ void __launch_bounds__(Wide::kThreads)
assign_wide_kernel(const float* __restrict__ x, const float* __restrict__ reps, int n, int L, int d, int span,
                   bool vec4, int* __restrict__ idx_out, float* __restrict__ dist_out, Key* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = Wide::R, CH = Wide::CH, SD = Wide::SD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * Wide::kRows;
  const int c_begin = blockIdx.y * span, c_end = min(L, c_begin + span);
  const int nslices = (d + Wide::W - 1) / Wide::W;
  const int steps = (c_end - c_begin + CH - 1) / CH * nslices;

  float xx[R], best[R], acc[2][R], nrm[2];
  int bidx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xx[r] = 0.f;
    best[r] = inf();
    bidx[r] = c_begin + lane < c_end ? c_begin + lane : INT_MAX;
  }
  stage_wide(smem, reps, x, c_begin, c_end, q0, n, d, 0, vec4);
  for (int t = 0; t < steps; ++t) {
    const int c = t / nslices, s = t - c * nslices;
    const int c0 = c_begin + c * CH;
    ws::cp_async_wait_all();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1's buffer
    if (t + 1 < steps) {
      const int c1 = (t + 1) / nslices;
      stage_wide(smem + ((t + 1) & 1) * Wide::kStage, reps, x, c_begin + c1 * CH, c_end, q0, n, d,
                 (t + 1 - c1 * nslices) * Wide::W, vec4);
    }
    const float* buf = smem + (t & 1) * Wide::kStage;
    const float4* y0 = reinterpret_cast<const float4*>(buf + lane * SD);
    const float4* y1 = reinterpret_cast<const float4*>(buf + (lane + 32) * SD);
    const float4* xs = reinterpret_cast<const float4*>(buf + (CH + warp * R) * SD);
    const int groups = (min(Wide::W, d - s * Wide::W) + 3) / 4;  // features past d are staged zeros
    if (s == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        nrm[u] = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[u][r] = 0.f;
      }
    }
    if (c == 0) {
      for (int g = 0; g < groups; ++g) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = xs[r * (SD / 4) + g];
          xx[r] = __fmaf_rn(xv.x, xv.x, xx[r]);
          xx[r] = __fmaf_rn(xv.y, xv.y, xx[r]);
          xx[r] = __fmaf_rn(xv.z, xv.z, xx[r]);
          xx[r] = __fmaf_rn(xv.w, xv.w, xx[r]);
        }
      }
    }
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
      const float4 v[2] = {y0[g], y1[g]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        nrm[u] = __fmaf_rn(v[u].x, v[u].x, nrm[u]);
        nrm[u] = __fmaf_rn(v[u].y, v[u].y, nrm[u]);
        nrm[u] = __fmaf_rn(v[u].z, v[u].z, nrm[u]);
        nrm[u] = __fmaf_rn(v[u].w, v[u].w, nrm[u]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xv = xs[r * (SD / 4) + g];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          acc[u][r] = __fmaf_rn(xv.x, v[u].x, acc[u][r]);
          acc[u][r] = __fmaf_rn(xv.y, v[u].y, acc[u][r]);
          acc[u][r] = __fmaf_rn(xv.z, v[u].z, acc[u][r]);
          acc[u][r] = __fmaf_rn(xv.w, v[u].w, acc[u][r]);
        }
      }
    }
    if (s == nslices - 1) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = c0 + 32 * u + lane;
        const float yn = j < c_end ? nrm[u] : inf();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float sq = repro::expanded_sq(xx[r], yn, acc[u][r]);
          if (sq < best[r]) {
            best[r] = sq;
            bidx[r] = j;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    repro::warp_argmin(best[r], bidx[r]);
    const int row = q0 + warp * R + r;
    if (lane == 0 && row < n) emit(best[r], bidx[r], row, n, part, idx_out, dist_out);
  }
}

// The minimum key of each row over the slices, into the outputs.
__global__ void assign_combine_kernel(const Key* __restrict__ part, int splits, int n, int* __restrict__ idx_out,
                                      float* __restrict__ dist_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Key k = part[i];
  for (int s = 1; s < splits; ++s) k = ws::kmin(k, part[(size_t)s * n + i]);
  idx_out[i] = ws::key_index(k);
  if (dist_out != nullptr) dist_out[i] = sqrtf(ws::key_dist(k));
}

struct Args {
  const float* x;
  const float* reps;
  int n, L, d, span, splits;
  int* idx;
  float* dist;
  Key* part;  // null: one slice, written directly
  cudaStream_t stream;
};

template <int D>
int launch_narrow(const Args& a) {
  using S = Shape<D>;
  const auto kernel = assign_ws_kernel<D>;
  const size_t smem = sizeof(float) * S::kSmemFloats;
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.reps) % 16 == 0;
  const dim3 grid((a.n + S::kRows - 1) / S::kRows, a.splits);
  kernel<<<grid, S::kThreads, smem, a.stream>>>(a.x, a.reps, a.n, a.L, a.d, a.span, vec4, a.idx, a.dist, a.part);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const Args& a) {
  const size_t smem = sizeof(float) * 2 * Wide::kStage;
  const cudaError_t err = repro::allow_smem(assign_wide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.reps) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const dim3 grid((a.n + Wide::kRows - 1) / Wide::kRows, a.splits);
  assign_wide_kernel<<<grid, Wide::kThreads, smem, a.stream>>>(a.x, a.reps, a.n, a.L, a.d, a.span, vec4, a.idx,
                                                               a.dist, a.part);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int plan(Kernel kernel, int rows, int threads, size_t smem, int* rows_per_block, int* blocks_per_sm) {
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
  *rows_per_block = rows;
  return static_cast<int>(err);
}

template <int D>
int plan_narrow(int* rows_per_block, int* blocks_per_sm) {
  using S = Shape<D>;
  return plan(assign_ws_kernel<D>, S::kRows, S::kThreads, sizeof(float) * S::kSmemFloats, rows_per_block,
              blocks_per_sm);
}

}  // namespace

// The launch plan for width d: query rows per block and the blocks one SM
// holds at once (the wrapper sizes the L split by them).  Returns a CUDA
// error code.
extern "C" int repro_assign_ws_plan(int d, int* rows_per_block, int* blocks_per_sm) {
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (d <= repro::kMaxDim ? ws::width_for(d) : 0) {
    case 16: return plan_narrow<16>(rows_per_block, blocks_per_sm);
    case 32: return plan_narrow<32>(rows_per_block, blocks_per_sm);
    case 64: return plan_narrow<64>(rows_per_block, blocks_per_sm);
    case 128: return plan_narrow<128>(rows_per_block, blocks_per_sm);
    default:
      return plan(assign_wide_kernel, Wide::kRows, Wide::kThreads, sizeof(float) * 2 * Wide::kStage, rows_per_block,
                  blocks_per_sm);
  }
}

// x (n, d), reps (L, d) row-major f32 on the device; idx_out (n,) int32;
// dist_out (n,) f32 or null; any d.  L is cut into at most `split` slices
// of ceil(L / split) reps; part holds split x n 64-bit keys when split > 1.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_assign_ws_f32(const void* x, const void* reps, int n, int L, int d, int split, void* idx_out,
                                   void* dist_out, void* part, void* stream) {
  if (n <= 0 || L <= 0 || d <= 0 || split < 1 || (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = (L + split - 1) / split;
  const int splits = (L + span - 1) / span;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(reps), n, L, d, span, splits,
               static_cast<int*>(idx_out), static_cast<float*>(dist_out),
               splits > 1 ? static_cast<Key*>(part) : nullptr, static_cast<cudaStream_t>(stream)};
  int code;
  if (d > repro::kMaxDim) {
    code = launch_wide(a);
  } else {
    switch (ws::width_for(d)) {
      case 16: code = launch_narrow<16>(a); break;
      case 32: code = launch_narrow<32>(a); break;
      case 64: code = launch_narrow<64>(a); break;
      default: code = launch_narrow<128>(a); break;
    }
  }
  if (code != 0 || splits == 1) return code;
  assign_combine_kernel<<<(n + 255) / 256, 256, 0, a.stream>>>(a.part, splits, n, a.idx, a.dist);
  return static_cast<int>(cudaGetLastError());
}
