// The exact-dynamic engine's two strip kernels redesigned for Hopper (plain
// C interface, sm_90a).  They take the place of csrc/dynamic.cu's
// strip_dists and strip_topk on every path; those stay as their bitwise
// oracles (kernels/dynamic.py: strip_dists_v1, strip_topk_v1).  No Pallas
// kernel stands behind either: they replace the jnp programs of the JAX
// package's exact-dynamic path,
//   strip_dists  repro/core/dynamic_jax.py::_strip_dists (:145) and
//                _dense_dists (:126);
//   strip_topk   the four lax.top_k calls of dynamic_jax.py (:187, :207,
//                :287, :429).
// Each is bit for bit its plain version in kernels/ref.py and the v1 kernel.
//
// strip_dists: (U, Np) distances sqrt(sum_k (r_k - x_k)^2) in the diff form
// (the state holds uncentred coordinates, where the expansion cancels), the
// sum in ascending k from +0 with __fsub_rn / __fmul_rn / __fadd_rn and
// never an FMA, then __fsqrt_rn.  Bound: instructions.  A (row, column,
// feature) costs three FP32 instructions, 3·U·Np·d in all, at 128 lanes an
// SM a clock (half the FMA peak): 0.253 ms at the stream's 5,376 x 32,768
// strip (d = 16), above the 0.211 ms of its 704 MB write.  v1 fed its 24 FP
// instructions a feature with 9 scalar shared-memory loads, and the loads
// set its pace.  Here a block of 256 threads computes a 64 x 128 tile and
// a thread an 8 x 4 tile in registers.  Rows and slots are staged as they
// lie (row-major, 16 features a stage, a padded stride) in shared memory
// by 16-byte cp.async copies that read whole rows, double-buffered when d
// is wider; for each 4 features a thread reads its 8 rows and 4 slots as
// twelve 16-byte loads for 384 FP instructions, so shared memory no longer
// sets the pace (PERF.md §6 splits what does, by probes: the root, the
// third FP instruction, the loop's issue).  A thread's rows and slots
// interleave with its neighbours', so that a quarter warp reads 8
// consecutive staged slots (no bank conflict) and a warp stores runs of
// consecutive columns, 4 bytes a store, so a row slice at any offset and an
// odd Np need no other path.  The stores are plain: streaming ones (__stcs)
// measured 2-4 % slower at the strip and at the square.
//
// strip_topk: the masked, ascending K smallest (distance, column) pairs of
// each strip row.  Bound: bytes, the strip read once per 1024 keys.  v1's
// warp had one 4-byte load a lane in flight before a vote that depends on
// it: 128 bytes a warp, ~5 KB an SM at the stream's ~41 warps an SM, where
// 3.35 TB/s at ~700 ns of latency wants ~15-20 KB.  Here a warp still owns
// a row, and each lane issues all 4 of its 16-byte loads of a 512-column
// chunk before it looks at any (~80 KB an SM in flight).  A lane then
// tests its 16 candidates' distance bits against the pass's range (the
// queue's k-th distance above, the last pass's key below), and one vote a
// chunk skips the chunk when no lane holds a candidate in range: after the
// first chunks, nearly every chunk.  Otherwise `alive` is read 4 bytes a
// lane for the columns of the lane's loads that hold one, and the
// candidates left are offered to warp_select.cuh's WarpSelect as in v1
// (key = (distance bits, column), so the order is the plain version's
// stable sort; a merge when a thread queue fills), one a lane a step with
// a vote a step, as many steps as the fullest lane has candidates (one
// merge site in the loop keeps the code, and its build, small).  A scalar
// head and tail take the columns before the row's first 16-byte boundary
// and after its last (a row view at any offset, Np % 4 != 0).  Above the largest warp queue (K >
// 1024) the row is streamed again for each further 1024 keys, above the
// last key taken.  Invalid rows write (+inf, -1) and read nothing.
//
// python -m repro_torch.kernels.strip_variants times other settings of the
// constants below (thread and block tiles, streaming stores; loads in
// flight, alive as bits, warps a block).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "warp_select.cuh"

namespace {

using repro::ws::Key;
using repro::ws::kEmpty;
using repro::ws::kFull;

// ------------------------------------------------------------ strip_dists
constexpr int kBM = 64, kBN = 128;  // block tile: rows x slots
constexpr int kTM = 8, kTN = 4;     // thread tile
constexpr bool kStream = false;     // plain stores (true: streaming, evict-first)
constexpr int kKC = 16;             // features a stage
constexpr int kLD = kKC + 4;        // staged row stride: 16-byte loads of 8 consecutive rows hit distinct banks

// A thread owns rows ty + kTY·i and slots tx + kTX·j of the block tile:
// the 8 threads of a quarter warp read 8 consecutive staged slots (and one
// row, a broadcast), and a warp stores runs of consecutive slots.
template <int BM_, int BN_, int TM_, int TN_>
struct Panel {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static_assert(BM % TM == 0 && BN % TN == 0 && BN / TN >= 8, "a quarter warp on 8 consecutive slots");
  static constexpr int kTX = BN / TN, kTY = BM / TM;  // threads along slots and rows
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kStage = (BM + BN) * kLD;  // floats a stage
  static constexpr int kMinBlocks = kThreads <= 256 ? 2 : 1;
};

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Start the copies of features [k0, k0 + kKC) of the n rows from r0 of an
// (m, d) row-major table into dst[r * kLD + k - k0], zero past m and d:
// 16 bytes a copy where d % 4 == 0 and the table is 16-byte aligned (vec4),
// else 4.  Neighbouring threads take neighbouring features of a row.
template <int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0, int n, int m, int d,
                                           int k0, bool vec4) {
  if (vec4) {
    for (int t = threadIdx.x; t < n * (kKC / 4); t += NT) {
      const int r = t / (kKC / 4), k = 4 * (t % (kKC / 4));
      const bool ok = r0 + r < m && k0 + k < d;
      repro::cp_async16(dst + r * kLD + k, ok ? src + (size_t)(r0 + r) * d + k0 + k : src, ok);
    }
  } else {
    for (int t = threadIdx.x; t < n * kKC; t += NT) {
      const int r = t / kKC, k = t % kKC;
      const bool ok = r0 + r < m && k0 + k < d;
      repro::cp_async4(dst + r * kLD + k, ok ? src + (size_t)(r0 + r) * d + k0 + k : src, ok);
    }
  }
}

// acc + (r - x)^2, rounded after each operation: never an FMA.
__device__ __forceinline__ float sq_step(float acc, float r, float x) {
  const float diff = __fsub_rn(r, x);
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

__device__ __forceinline__ void store1(float* p, float v) {
  if constexpr (kStream) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

template <typename P>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
strip_dists_tile_kernel(const float* __restrict__ rows, int U, const float* __restrict__ X, int Np, int d, bool vec4,
                        float* __restrict__ out) {
  constexpr int BM = P::BM, BN = P::BN, TM = P::TM, TN = P::TN;
  __shared__ __align__(16) float smem[2 * P::kStage];
  const int tx = threadIdx.x % P::kTX, ty = threadIdx.x / P::kTX;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const int nk = (d + kKC - 1) / kKC;
  auto stage = [&](int s) {
    float* a = smem + (s & 1) * P::kStage;
    stage_rows<P::kThreads>(a, rows, r0, BM, U, d, s * kKC, vec4);
    stage_rows<P::kThreads>(a + BM * kLD, X, c0, BN, Np, d, s * kKC, vec4);
    repro::cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < nk; ++s) {
    if (s + 1 < nk) {  // the next stage lands while this one is summed
      stage(s + 1);
      cp_async_wait_one();
    } else {
      repro::cp_async_wait_all();
    }
    __syncthreads();
    const float* a = smem + (s & 1) * P::kStage + ty * kLD;
    const float* b = smem + (s & 1) * P::kStage + (BM + tx) * kLD;
    // groups of 4 features holding one below d; the zeros staged past d add (0 - 0)^2 = +0, which leaves
    // every sum (>= +0) as it is
    const int groups = (min(kKC, d - s * kKC) + 3) / 4;
#pragma unroll
    for (int g = 0; g < kKC / 4; ++g) {
      if (g < groups) {
        float4 ra[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = *reinterpret_cast<const float4*>(a + i * P::kTY * kLD + 4 * g);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 cb = *reinterpret_cast<const float4*>(b + j * P::kTX * kLD + 4 * g);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            float v = sq_step(acc[i][j], ra[i].x, cb.x);
            v = sq_step(v, ra[i].y, cb.y);
            v = sq_step(v, ra[i].z, cb.z);
            acc[i][j] = sq_step(v, ra[i].w, cb.w);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + P::kTY * i;
    if (r < U) {
      float* orow = out + (size_t)r * Np;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + tx + P::kTX * j;
        if (c < Np) store1(orow + c, __fsqrt_rn(acc[i][j]));
      }
    }
  }
}

// ------------------------------------------------------------- strip_topk
constexpr int kTopkWarps = 4;
constexpr int kVec = 4;             // 16-byte loads a lane has in flight (a chunk of 128·kVec columns)
constexpr bool kAliveBits = false;  // alive as bytes; true: packed into shared-memory bits once a block

template <int K>
struct TopkShape {
  static constexpr int T = K <= 64 ? 2 : (K <= 256 ? 4 : 8);  // thread-queue length, as v1
  // the 1024-key queue needs more than the 128 registers two blocks an SM allow
  static constexpr int kMinBlocks = K < 1024 ? 2 : 1;
};

// The live columns: bytes in device memory, or (BITS) bit j of word j / 32
// in shared memory.
template <bool BITS>
struct Alive {
  const bool* bytes;
  const unsigned* bits;

  __device__ __forceinline__ bool one(int j) const {
    if constexpr (BITS) {
      return (bits[j >> 5] >> (j & 31)) & 1u;
    } else {
      return bytes[j];
    }
  }

  // Bit e set where column j + e is live (j + 3 < Np): one 4-byte load
  // where the bytes are aligned.
  __device__ __forceinline__ unsigned four(int j) const {
    if constexpr (BITS) {
      const int s = j & 31;
      const unsigned lo = bits[j >> 5] >> s;
      const unsigned hi = s > 28 ? bits[(j >> 5) + 1] << (32 - s) : 0u;
      return (lo | hi) & 0xfu;
    } else {
      const auto* p = reinterpret_cast<const unsigned char*>(bytes) + j;
      const unsigned w = (reinterpret_cast<uintptr_t>(p) & 3) == 0
                             ? *reinterpret_cast<const unsigned*>(p)
                             : p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<unsigned>(p[3]) << 24);
      return (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);  // bools are 0 or 1
    }
  }
};

// Bit e set where distance e of x has its bits in [lo, hi] (distances are
// >= +0, so their bits order as the distances do).
__device__ __forceinline__ unsigned in_range(float4 x, unsigned lo, unsigned hi) {
  const unsigned a = __float_as_uint(x.x), b = __float_as_uint(x.y), c = __float_as_uint(x.z),
                 e = __float_as_uint(x.w);
  return static_cast<unsigned>(a >= lo && a <= hi) | (static_cast<unsigned>(b >= lo && b <= hi) << 1) |
         (static_cast<unsigned>(c >= lo && c <= hi) << 2) | (static_cast<unsigned>(e >= lo && e <= hi) << 3);
}

// Distance c (float4 c / 4, component c % 4) of x, by selects: a runtime
// index into a register array would put the array in local memory.
template <int V>
__device__ __forceinline__ float pick(const float4 (&x)[V], int c) {
  float v = x[0].x;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    v = c == 4 * u + 1 ? x[u].y : v;
    v = c == 4 * u + 2 ? x[u].z : v;
    v = c == 4 * u + 3 ? x[u].w : v;
    if (u > 0) v = c == 4 * u ? x[u].x : v;
  }
  return v;
}

// One warp per row: passes of K (the queue) keys, each above the last key
// the previous pass took, until k keys are out or the row runs dry.
template <int K, int V, bool BITS>
__global__ void __launch_bounds__(32 * kTopkWarps, TopkShape<K>::kMinBlocks)
strip_topk_vec_kernel(const float* __restrict__ D, int U, int Np, const int* __restrict__ row_ids,
                      const bool* __restrict__ row_valid, const bool* __restrict__ alive, int k,
                      float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int T = TopkShape<K>::T;
  extern __shared__ unsigned alive_bits[];
  if constexpr (BITS) {  // one coalesced byte a thread, a ballot a warp
    for (int b0 = 0; b0 < Np; b0 += blockDim.x) {
      const int j = b0 + threadIdx.x;
      const unsigned m = __ballot_sync(kFull, j < Np && alive[j]);
      if ((threadIdx.x & 31) == 0 && j < Np) alive_bits[j >> 5] = m;
    }
    __syncthreads();
  }
  const Alive<BITS> al{alive, alive_bits};
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kTopkWarps + (threadIdx.x >> 5);
  if (row >= U) return;  // warp-uniform
  const bool rv = row_valid[row];
  const int self = row_ids[row];
  const float* drow = D + (size_t)row * Np;
  // head columns before the first 16-byte boundary, nvec float4s, tail columns from tail0
  const int head = min(Np, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(drow) >> 2) & 3)) & 3));
  const int nvec = (Np - head) >> 2;
  const int tail0 = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(drow + head);
  // this lane's head or tail column (lanes 0-2 and 4-6), or -1
  const int edge = lane < head ? lane : (lane >= 4 && lane - 4 < Np - tail0 ? tail0 + lane - 4 : -1);
  Key lo = 0;
  bool dry = false;
  for (int kdone = 0; kdone < k; kdone += K) {
    const int kq = min(K, k - kdone);
    repro::ws::WarpSelect<K, T> sel;
    sel.init();
    if (rv && !dry) {
      const unsigned lo_bits = static_cast<unsigned>(lo >> 32);
      {
        const bool in = edge >= 0;
        const Key key = repro::ws::make_key(in ? drow[edge] : 0.f, edge);
        sel.offer_key(key, in && al.one(edge) && edge != self && key >= lo);
        if (__any_sync(kFull, sel.nv == T)) sel.merge(lane, kq);
      }
      for (int v0 = 0; v0 < nvec; v0 += 32 * V) {
        float4 x[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {  // every load of the chunk before any is used
          const int q = v0 + 32 * u + lane;
          x[u] = q < nvec ? __ldcs(body + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        // bit 4u + e: the candidate in column head + 4 (v0 + 32u + lane) + e lies in the pass's range
        const unsigned hi_bits = static_cast<unsigned>(sel.kth >> 32);
        unsigned pend = 0;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (v0 + 32 * u + lane < nvec) pend |= in_range(x[u], lo_bits, hi_bits) << (4 * u);
        }
        if (!__any_sync(kFull, pend != 0)) continue;
#pragma unroll
        for (int u = 0; u < V; ++u) {  // keep the live columns other than the row's own
          if ((pend >> (4 * u)) & 0xfu) {
            const int j = head + 4 * (v0 + 32 * u + lane);
            unsigned live = al.four(j);
            if (self >= j && self < j + 4) live &= ~(1u << (self - j));
            pend &= ~((~live & 0xfu) << (4 * u));
          }
        }
        // one candidate a lane a step, a vote a step: as many steps as the fullest lane has candidates
        while (__any_sync(kFull, pend != 0)) {
          const bool has = pend != 0;
          const int c = has ? __ffs(pend) - 1 : 0;
          pend &= pend - 1;
          const int j = head + 4 * (v0 + 32 * (c >> 2) + lane) + (c & 3);
          const Key key = repro::ws::make_key(pick(x, c), j);
          sel.offer_key(key, has && key >= lo);
          if (__any_sync(kFull, sel.nv == T)) sel.merge(lane, kq);
        }
      }
      sel.merge_if(sel.nv > 0, lane, kq);
    }
    // write entries kdone .. kdone + kq - 1 (element q * 32 + lane of the queue)
#pragma unroll
    for (int q = 0; q < K / 32; ++q) {
      const int e = q * 32 + lane;
      if (e < kq) {
        const Key key = sel.w[q];
        const float dist = key == kEmpty ? __int_as_float(0x7f800000) : repro::ws::key_dist(key);
        const bool fin = key != kEmpty && isfinite(dist);
        out_d[(size_t)row * k + kdone + e] = dist;
        out_i[(size_t)row * k + kdone + e] = fin ? repro::ws::key_index(key) : -1;
      }
    }
    if (sel.kth == kEmpty) dry = true;  // fewer than kq keys were left
    else lo = sel.kth + 1;
  }
}

template <int K>
int launch_topk(const float* D, int U, int Np, const int* row_ids, const bool* row_valid, const bool* alive, int k,
                float* out_d, int* out_i, cudaStream_t stream) {
  auto* kern = strip_topk_vec_kernel<K, kVec, kAliveBits>;
  const size_t smem = kAliveBits ? sizeof(unsigned) * (((size_t)Np + 31) / 32) : 0;
  const cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(U + kTopkWarps - 1) / kTopkWarps, 32 * kTopkWarps, smem, stream>>>(D, U, Np, row_ids, row_valid, alive, k,
                                                                             out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (U, d) and X (Np, d) f32 row-major -> out (U, Np) f32 at any
// 4-byte aligned address.
extern "C" int repro_strip_dists_tiles_f32(const void* rows, int U, const void* X, int Np, int d, void* out,
                                           void* stream) {
  using P = Panel<kBM, kBN, kTM, kTN>;
  if (U <= 0 || Np <= 0) return 0;
  if (d <= 0 || (U + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = d % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  const dim3 grid((Np + kBN - 1) / kBN, (U + kBM - 1) / kBM);
  strip_dists_tile_kernel<P><<<grid, P::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), U, static_cast<const float*>(X), Np, d, vec4, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// D (U, Np) f32 at any 4-byte aligned address, row_ids (U,) int32,
// row_valid (U,) bool, alive (Np,) bool -> out_d (U, k) f32, out_i (U, k)
// int32.
extern "C" int repro_strip_topk_tiles_f32(const void* D, int U, int Np, const void* row_ids, const void* row_valid,
                                          const void* alive, int k, void* out_d, void* out_i, void* stream) {
  if (U <= 0 || k <= 0) return 0;
  const auto* d = static_cast<const float*>(D);
  const auto* ids = static_cast<const int*>(row_ids);
  const auto* rv = static_cast<const bool*>(row_valid);
  const auto* al = static_cast<const bool*>(alive);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (repro::ws::queue_for(k < 1024 ? k : 1024)) {
    case 32: return launch_topk<32>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 64: return launch_topk<64>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 128: return launch_topk<128>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 256: return launch_topk<256>(d, U, Np, ids, rv, al, k, od, oi, s);
    case 512: return launch_topk<512>(d, U, Np, ids, rv, al, k, od, oi, s);
    default: return launch_topk<1024>(d, U, Np, ids, rv, al, k, od, oi, s);
  }
}
