// One Borůvka round's strip minima from the strip's factors (plain C
// interface, sm_90a): the redesign of dynamic.cu's strip_round_minima.
//
// No Pallas kernel stands behind it: it replaces the strip reductions of one
// round of repro/core/mst.py::boruvka_strip_jax (:777-819), fed the weights
// that repro/core/dynamic_jax.py::insert_batch builds (:223).  Given the
// (U, n) distance strip D, the core distances cd, the strip rows' nodes sids,
// the rows' validity, the live columns and the round's labels, it returns per
// strip row and per column the lexicographic minimum of
//   (w = max(max(D[r, c], cd[sids[r]]), cd[c]),  pair id min(s, c)·n + max(s, c),  payload E + r·n + c)
// over the active entries row_valid[r] & alive[c] & lab[sids[r]] != lab[c]
// (which implies c != sids[r]); (+inf, int32 max, int32 max) where there is
// none.  The outputs are bit for bit those of dynamic.cu's kernel fed the
// SW and smask built from the same factors, and of kernels/ref.py.
//
// Bound: bytes.  D is read once, 4 bytes an entry (the vectors are a few
// hundred KB); at the exact engine's 5,376 x 32,768 strip that is 704.6 MB,
// 0.2103 ms at 3.35 TB/s, and an entry that no input makes active need not
// be read at all.  The first version read SW (4 B) and smask (1 B) twice,
// once for the rows and once for the columns, the column pass one thread per
// column walking all U rows.  Here:
//   - one pass: a block owns a chunk of rows x kTC = 256 columns; a lane
//     owns kCols = 8 columns (two float4 groups, 16-byte loads; 16 columns a
//     lane measured slower at every label set on the H100) and keeps their
//     labels, core distances and running column minima in registers across
//     the block's rows, so both minima come from one read of each entry;
//   - row minima: a lane's best over its columns, then two redux.sync mins
//     over the warp (weight bits, then pair id among the weight's holders);
//     a row's pair ids are distinct, and its column follows from the pair id
//     and sids[r], so the payload is formed in the merge;
//   - column minima: per lane over the rows in ascending order (a strict <
//     keeps the lowest row on a tied key), then over the block's eight warps
//     through shared memory, then over the row chunks in the merge launch;
//   - the merge: a second, small launch reduces the per-tile partials and
//     writes the outputs (pair ids and payloads as int64).  The order
//     (w bits, pair id, row) is total, so any merge order gives the same
//     bits, with no float atomics;
//   - rows are dealt to the chunks in stride (row k, k + nrc, ...), so the
//     live rows of a strip whose tail is dead spread over all blocks, and a
//     block compacts its live rows into shared memory first, in one pass: a
//     dead row is never read and its result is written empty by the merge;
//   - a lane skips the 16-byte load and the compute of a group whose four
//     columns are all dead or all in the row's own component (most of the
//     strip in the late rounds, and every dead slot of the table in all of
//     them); a row with no such group in the whole warp skips its reduction;
//   - the weights' max is max.NaN.f32, so a NaN anywhere gives a NaN weight
//     that, as in the first version, never beats the empty key; an inactive
//     entry's weight bits are 0xffffffff, above every key.
// Weights are >= 0 on the path, so (w bits, pair id) orders as the tuple
// does.  Labels are node ids in [0, n), held as int32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kBig = 0x7fffffffu;      // int32 max: the empty pair id and payload
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: the empty weight
constexpr unsigned kOff = 0xffffffffu;      // an inactive entry's weight bits, above every key
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMaxRows = 1024;  // rows of one chunk (staged in shared memory)
constexpr int kPer = kMaxRows / kThreads;  // chunk rows a thread stages
constexpr int kWaves = 4;       // blocks per resident slot the plan aims for
constexpr int kGroups = 2;      // float4 groups a lane
constexpr int kCols = 4 * kGroups, kTC = 32 * kCols;  // columns a lane, a block

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ bool key_less(unsigned h, unsigned l, unsigned bh, unsigned bl) {
  return h < bh || (h == bh && l < bl);
}

__device__ __forceinline__ bool lex_less(unsigned h, unsigned l, int r, unsigned bh, unsigned bl, int br) {
  return h < bh || (h == bh && (l < bl || (l == bl && r < br)));
}

// Grid (nct, nrc): block (t, k) takes columns [t·kTC, t·kTC + kTC) and the rows
// k, k + nrc, k + 2·nrc, ... below U.  Writes rpart[t·U + r] (the row's
// (w bits, pair id) over the tile's columns) for its live rows and
// (cph, cpl, cpr)[k·n + c] (the column's (w bits, pair id, row) over the
// chunk's rows) for every column of the tile.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
minima_tile_kernel(const float* __restrict__ D, const float* __restrict__ cd, const int* __restrict__ sids,
                   const bool* __restrict__ row_valid, const bool* __restrict__ alive,
                   const long long* __restrict__ lab, int U, int n, int nrc,
                   unsigned long long* __restrict__ rpart, unsigned* __restrict__ cph, unsigned* __restrict__ cpl,
                   int* __restrict__ cpr) {
  constexpr int C = kCols, TC = kTC, Q = kGroups;
  __shared__ int s_row[kMaxRows], s_sid[kMaxRows], s_slab[kMaxRows];
  __shared__ float s_cdr[kMaxRows];
  __shared__ int s_cnt[kWarps];
  __shared__ unsigned s_h[kWarps / 2][TC], s_l[kWarps / 2][TC];
  __shared__ int s_r[kWarps / 2][TC];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, k = blockIdx.y;

  // the lane's columns: labels, core distances (NaN where dead) and minima
  const int c0 = t * TC + lane * 4;
  int lc[C];
  float cc[C];
  unsigned bh[C], bl[C];
  int br[C];
  unsigned dead = 0;  // bit q: group q's four columns are all dead
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    bool all_dead = true;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e, c = c0 + 128 * q + e;
      const bool live = c < n && alive[c];
      lc[i] = c < n ? static_cast<int>(lab[c]) : -1;
      cc[i] = live ? cd[c] : __uint_as_float(kBig);
      all_dead &= !live;
      bh[i] = kInfBits;
      bl[i] = kBig;
      br[i] = -1;
    }
    dead |= all_dead ? 1u << q : 0u;
  }

  // the chunk's live rows, compacted in ascending order in one pass: thread
  // tid takes the chunk's rows tid·kPer .. tid·kPer + kPer − 1
  const int rows_k = (U - k + nrc - 1) / nrc;
  bool ok[kPer];
  int sid[kPer];
  unsigned cnt = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = tid * kPer + p, r = k + j * nrc;
    ok[p] = j < rows_k && row_valid[r];
    sid[p] = j < rows_k ? sids[r] : 0;
    cnt += ok[p] ? 1u : 0u;
  }
  unsigned incl = cnt;  // inclusive scan of the counts over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    incl += lane >= o ? y : 0u;
  }
  if (lane == 31) s_cnt[warp] = static_cast<int>(incl);
  __syncthreads();
  int at = static_cast<int>(incl - cnt), nrows = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_cnt[w];
    at += w < warp ? c : 0;
    nrows += c;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (ok[p]) {
      s_row[at] = k + (tid * kPer + p) * nrc;
      s_sid[at] = sid[p];
      s_slab[at] = static_cast<int>(lab[sid[p]]);
      s_cdr[at] = cd[sid[p]];
      ++at;
    }
  }
  __syncthreads();

  float v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = 0.f;
  for (int i = warp; i < nrows; i += kWarps) {
    const int r = s_row[i], s = s_sid[i], sl = s_slab[i];
    const float cr = s_cdr[i];
    const float* drow = D + static_cast<size_t>(r) * n + c0;
    // the groups with an entry outside the row's component and a live column: loads first, then the compute
    unsigned need = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const bool any = lc[4 * q] != sl || lc[4 * q + 1] != sl || lc[4 * q + 2] != sl || lc[4 * q + 3] != sl;
      if (any && !((dead >> q) & 1u)) {
        need |= 1u << q;
        if (kVec) {
          const float4 x = __ldcs(reinterpret_cast<const float4*>(drow + 128 * q));
          v[4 * q] = x.x;
          v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z;
          v[4 * q + 3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + 128 * q + e < n) v[4 * q + e] = __ldcs(drow + 128 * q + e);
        }
      }
    }
    if (!__any_sync(kFull, need)) {  // the whole row is in its own component or dead here
      if (lane == 0) rpart[static_cast<size_t>(t) * U + r] = (static_cast<unsigned long long>(kInfBits) << 32) | kBig;
      continue;
    }
    unsigned rh = kInfBits, rl = kBig;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (!((need >> q) & 1u)) continue;  // no entry of the group can win
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * q + e, c = c0 + 128 * q + e;
        const float w = max_nan(max_nan(v[j], cr), cc[j]);
        const unsigned h = lc[j] != sl ? __float_as_uint(w) : kOff;
        const unsigned l =
            static_cast<unsigned>(min(s, c)) * static_cast<unsigned>(n) + static_cast<unsigned>(max(s, c));
        if (key_less(h, l, rh, rl)) {
          rh = h;
          rl = l;
        }
        if (key_less(h, l, bh[j], bl[j])) {
          bh[j] = h;
          bl[j] = l;
          br[j] = r;
        }
      }
    }
    const unsigned mh = __reduce_min_sync(kFull, rh);
    const unsigned ml = __reduce_min_sync(kFull, rh == mh ? rl : kOff);
    if (lane == 0) rpart[static_cast<size_t>(t) * U + r] = (static_cast<unsigned long long>(mh) << 32) | ml;
  }

  // columns over the block's warps: 8 -> 4 -> 2 -> 1 through shared memory
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int at = 128 * (j / 4) + lane * 4 + j % 4;
        s_h[warp - half][at] = bh[j];
        s_l[warp - half][at] = bl[j];
        s_r[warp - half][at] = br[j];
      }
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int at = 128 * (j / 4) + lane * 4 + j % 4;
        const unsigned h = s_h[warp][at], l = s_l[warp][at];
        const int rr = s_r[warp][at];
        if (lex_less(h, l, rr, bh[j], bl[j], br[j])) {
          bh[j] = h;
          bl[j] = l;
          br[j] = rr;
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = c0 + 128 * (j / 4) + j % 4;
      if (c < n) {
        const size_t at = static_cast<size_t>(k) * n + c;
        cph[at] = bh[j];
        cpl[at] = bl[j];
        cpr[at] = br[j];
      }
    }
  }
}

constexpr int kMergeThreads = 256;

// Blocks [0, col_blocks) merge the columns over the nrc row chunks, the rest
// the rows over the nct column tiles, and write the six outputs.
__global__ void __launch_bounds__(kMergeThreads)
minima_merge_kernel(const unsigned long long* __restrict__ rpart, const unsigned* __restrict__ cph,
                    const unsigned* __restrict__ cpl, const int* __restrict__ cpr, const int* __restrict__ sids,
                    const bool* __restrict__ row_valid, int U, int n, int nrc, int nct, int E, int col_blocks,
                    float* __restrict__ rw, long long* __restrict__ re, long long* __restrict__ rp,
                    float* __restrict__ cw, long long* __restrict__ ce, long long* __restrict__ cp) {
  if (static_cast<int>(blockIdx.x) < col_blocks) {
    const int c = blockIdx.x * kMergeThreads + threadIdx.x;
    if (c >= n) return;
    unsigned bh = kInfBits, bl = kBig;
    int br = -1;
#pragma unroll 8
    for (int k = 0; k < nrc; ++k) {
      const size_t at = static_cast<size_t>(k) * n + c;
      const unsigned h = cph[at], l = cpl[at];
      const int r = cpr[at];
      if (lex_less(h, l, r, bh, bl, br)) {
        bh = h;
        bl = l;
        br = r;
      }
    }
    cw[c] = __uint_as_float(bh);
    ce[c] = bl;
    cp[c] = bl == kBig ? kBig : E + static_cast<long long>(br) * n + c;
    return;
  }
  const int r = (blockIdx.x - col_blocks) * kMergeThreads + threadIdx.x;
  if (r >= U) return;
  unsigned long long best = (static_cast<unsigned long long>(kInfBits) << 32) | kBig;
  if (row_valid[r]) {
#pragma unroll 8
    for (int t = 0; t < nct; ++t) best = min(best, rpart[static_cast<size_t>(t) * U + r]);
  }
  const unsigned h = static_cast<unsigned>(best >> 32), l = static_cast<unsigned>(best);
  long long pay = kBig;
  if (l != kBig) {  // the pair (s, c) with s = sids[r]: c is the end that is not s
    const unsigned s = static_cast<unsigned>(sids[r]), a = l / static_cast<unsigned>(n),
                   b = l % static_cast<unsigned>(n);
    pay = E + static_cast<long long>(r) * n + (a == s ? b : a);
  }
  rw[r] = __uint_as_float(h);
  re[r] = l;
  rp[r] = pay;
}

int resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minima_tile_kernel<true>, kThreads, 0);
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(err);
}

}  // namespace

// The launch plan for a (U, n) strip: the row chunks nrc (enough blocks
// for kWaves per resident slot, at most kMaxRows rows a chunk, at most U
// chunks) and the column tiles nct.  The caller's scratch holds nct·U
// 64-bit row partials, then nrc·n column partials of 12 bytes.  Returns a
// CUDA error code.
extern "C" int repro_strip_minima_plan(int U, int n, int* nrc, int* nct) {
  if (U < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  *nct = (n + kTC - 1) / kTC;
  *nrc = 0;
  if (U == 0 || n == 0) return 0;
  int resident = 0;
  const int err = resident_blocks(&resident);
  const int want = (kWaves * resident + *nct - 1) / *nct;
  const int least = (U + kMaxRows - 1) / kMaxRows;
  *nrc = want > least ? (want < U ? want : U) : least;
  return err;
}

// D (U, n) f32 row-major, cd (n,) f32, sids (U,) int32, row_valid (U,) bool,
// alive (n,) bool, lab (n,) int64 node ids, payload offset E, nrc from the
// plan, scratch as the plan says -> row minima (U,) and column minima (n,):
// w f32, pair id and payload int64.  Two launches.
extern "C" int repro_strip_round_minima_from_dists_f32(const void* D, const void* cd, const void* sids,
                                                       const void* row_valid, const void* alive, const void* lab,
                                                       int U, int n, int E, int nrc, void* scratch, void* rw, void* re,
                                                       void* rp, void* cw, void* ce, void* cp, void* stream) {
  const bool tiles_run = U > 0 && n > 0;
  if (U < 0 || n < 0 || (tiles_run && (nrc < 1 || nrc > U || nrc > 65535 || (U + nrc - 1) / nrc > kMaxRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (U + n == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nct = (n + kTC - 1) / kTC;
  auto* rpart = static_cast<unsigned long long*>(scratch);
  auto* cph = reinterpret_cast<unsigned*>(rpart + static_cast<size_t>(nct) * U);
  auto* cpl = cph + static_cast<size_t>(nrc) * n;
  auto* cpr = reinterpret_cast<int*>(cpl + static_cast<size_t>(nrc) * n);
  const auto* si = static_cast<const int*>(sids);
  const auto* rv = static_cast<const bool*>(row_valid);
  if (tiles_run) {
    const dim3 grid(nct, nrc);
    const auto* d = static_cast<const float*>(D);
    const auto* c = static_cast<const float*>(cd);
    const auto* al = static_cast<const bool*>(alive);
    const auto* lb = static_cast<const long long*>(lab);
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(D) % 16 == 0)
      minima_tile_kernel<true><<<grid, kThreads, 0, s>>>(d, c, si, rv, al, lb, U, n, nrc, rpart, cph, cpl, cpr);
    else
      minima_tile_kernel<false><<<grid, kThreads, 0, s>>>(d, c, si, rv, al, lb, U, n, nrc, rpart, cph, cpl, cpr);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int col_blocks = (n + kMergeThreads - 1) / kMergeThreads;
  const int row_blocks = (U + kMergeThreads - 1) / kMergeThreads;
  minima_merge_kernel<<<col_blocks + row_blocks, kMergeThreads, 0, s>>>(
      rpart, cph, cpl, cpr, si, rv, U, n, nrc, nct, E, col_blocks, static_cast<float*>(rw),
      static_cast<long long*>(re), static_cast<long long*>(rp), static_cast<float*>(cw), static_cast<long long*>(ce),
      static_cast<long long*>(cp));
  return static_cast<int>(cudaGetLastError());
}
